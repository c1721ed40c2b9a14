"""The port's hot cross-section host modules against mcrat_tpu, in float64.

* Tables: the port's ``build_thermal_table`` / ``build_nonthermal_table``
  (float64 torch) equal JAX's (float64 XLA) to rtol 1e-10 with atol 1e-11
  on log10 sigma_hat.  The atol covers entries near log10 sigma_hat = 0:
  there the closed-form Klein-Nishina integrand just above e = 1e-3 keeps
  only ~1e-10 relative in float64 (its ~2/e^2 terms cancel), and XLA's and
  torch's log1p/exp differ by ulps (measured: 1.4e-12 at most).
* The npz cache: a file either package wrote loads in the other (the other
  package's builder is made to raise, so nothing is rebuilt).
* The per-cell Chebyshev rows: the port's float64 ``thermal_cheb_cells``
  equals JAX's float64 rows to 1e-9 for theta from 1e-6 to 1e4, and stays
  within the 1 % sigma_hat bound of ``interp_thermal`` that
  tests/test_hot_xsec.py::test_thermal_cheb_cells_matches_interp holds.
* Interpolation, the subgroup-1 fit, the special functions and the
  nonthermal host functions equal JAX's to 1e-9 .. 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu.config import BFieldCalc, Config
from mcrat_tpu.constants import KB_OVER_MEC2
from mcrat_tpu.models.analytic import synthetic_spherical_frame
from mcrat_tpu.ops import cyclosynch as jcs
from mcrat_tpu.ops import electrons as jel
from mcrat_tpu.ops import hot_xsec as jhx
from mcrat_tpu.ops import special as jsp
from mcrat_tpu_torch import convert
from mcrat_tpu_torch.ops import cyclosynch as tcs
from mcrat_tpu_torch.ops import electrons as tel
from mcrat_tpu_torch.ops import hot_xsec as thx
from mcrat_tpu_torch.ops import special as tsp

from test_torch_geometry_cases import NT_DISTS, table_cfg

TABLE_RTOL, TABLE_ATOL = 1e-10, 1e-11


@pytest.fixture(scope="module")
def thermal():
    """(JAX's, the port's) float64 thermal tables, built once per module."""
    return jhx.build_thermal_table(), thx.build_thermal_table()


def _cfg(dist):
    return table_cfg(Config(dtype="float64"), dist)


def test_thermal_table_matches_jax(thermal):
    (le_j, lt_j, tab_j), (le_t, lt_t, tab_t) = thermal
    np.testing.assert_array_equal(le_t, le_j)
    np.testing.assert_array_equal(lt_t, lt_j)
    assert tab_t.shape == (thx.N_PH_E + 1, thx.N_T + 1) and tab_t.dtype == np.float64
    np.testing.assert_allclose(tab_t, tab_j, rtol=TABLE_RTOL, atol=TABLE_ATOL)


@pytest.mark.parametrize("dist", sorted(NT_DISTS))
def test_nonthermal_table_matches_jax(dist):
    cfg = _cfg(dist)
    tcfg = convert.config_from_reference(cfg)
    _, tab_j = jhx.build_nonthermal_table(cfg)
    _, tab_t = thx.build_nonthermal_table(tcfg)
    assert tab_t.shape == (thx.N_PH_E + 1, cfg.n_gamma)
    np.testing.assert_allclose(tab_t, tab_j, rtol=TABLE_RTOL, atol=TABLE_ATOL)


def test_cache_written_by_either_package_loads_in_the_other(tmp_path, monkeypatch):
    cfg = _cfg("powerlaw")
    tcfg = convert.config_from_reference(cfg)
    assert thx._cache_header(tcfg) == jhx._cache_header(cfg)
    assert thx.CACHE_VERSION == jhx.CACHE_VERSION
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tp = thx.load_or_build(tcfg, port_path, device="cpu")  # builds and writes
    tj = jhx.load_or_build(cfg, jax_path, dtype="float64")  # builds and writes

    def no_build(*args, **kwargs):
        raise AssertionError("the cache should have been loaded")

    for mod in (jhx, thx):
        monkeypatch.setattr(mod, "build_thermal_table", no_build)
        monkeypatch.setattr(mod, "build_nonthermal_table", no_build)
    from_jax = thx.load_or_build(tcfg, jax_path, device="cpu")
    for name in ("log_e", "log_t", "thermal", "nonthermal", "subgroup_frac"):
        np.testing.assert_array_equal(getattr(from_jax, name), np.asarray(getattr(tj, name)))
    from_port = jhx.load_or_build(cfg, port_path, dtype="float64")
    for name in ("log_e", "log_t", "thermal", "nonthermal"):
        np.testing.assert_array_equal(np.asarray(getattr(from_port, name)), getattr(tp, name))
    # the other config's header does not match: it would rebuild
    with pytest.raises(AssertionError, match="loaded"):
        thx.load_or_build(convert.config_from_reference(_cfg("broken")), jax_path,
                          device="cpu")


def _jax_table(thermal_arrays):
    le, lt, tab = thermal_arrays
    return jhx.HotCrossSectionTable(log_e=jnp.asarray(le), log_t=jnp.asarray(lt),
                                    thermal=jnp.asarray(tab))


def test_cheb_rows_match_jax_float64(thermal):
    jax_arrays = thermal[0]
    temps = np.geomspace(1e-6, 1e4, 257) / KB_OVER_MEC2
    want = np.asarray(jhx.thermal_cheb_cells(_jax_table(jax_arrays), jnp.asarray(temps)))
    port_table = convert.xsec_table_from_numpy(*jax_arrays)
    got = thx.thermal_cheb_cells(port_table, torch.from_numpy(temps), dtype=torch.float64)
    assert got.shape == (thx.CHEB_ROWS, len(temps)) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    rows32 = thx.thermal_cheb_cells(port_table, torch.from_numpy(temps))
    assert rows32.dtype == torch.float32
    np.testing.assert_array_equal(rows32.numpy(), got.numpy().astype(np.float32))


def _cheb_sigma(rows, c, e):
    """sigma_hat of cell c's Chebyshev rows at energies e (float64 numpy)."""
    dlo, dhi = thx.CHEB_DLO, thx.CHEB_DHI
    invk = rows[0, c]
    s = -np.log10(invk)
    x = e * invk
    lo = x < 1.0
    t = np.where(lo, 2.0 * x - 1.0,
                 np.clip(2.0 * np.log10(np.maximum(x, 1e-300)) / (thx.LOG_PH_E_MAX - s) - 1.0,
                         -1.0, 1.0))
    c_lo = np.concatenate([rows[1:2 + dlo, c], np.zeros(dhi - dlo)])
    coeffs = np.where(lo[None, :], c_lo[:, None], rows[2 + dlo:, c][:, None])
    fit = sum(coeffs[k] * np.cos(k * np.arccos(np.clip(t, -1, 1))) for k in range(dhi + 1))
    return 10.0 ** fit


def test_cheb_rows_within_interp_bound(thermal):
    table = convert.xsec_table_from_numpy(*thermal[1])
    temps = np.array([5e8, 5e9, 1e11, 1e5])  # theta ~ 0.08, 0.8, 16, below the floor
    rows = thx.thermal_cheb_cells(table, torch.from_numpy(temps), dtype=torch.float64).numpy()
    e = 10.0 ** np.random.default_rng(0).uniform(-11.5, 5.5, 256)
    for c, temp in enumerate(temps):
        exact = thx.interp_thermal(table, torch.from_numpy(e),
                                   torch.full((len(e),), temp, dtype=torch.float64)).numpy()
        rel = np.abs(_cheb_sigma(rows, c, e) - exact) / np.maximum(exact, 1e-30)
        assert rel.max() < 0.01, (temp, rel.max())


def test_interpolation_matches_jax(thermal):
    jax_arrays = thermal[0]
    cfg = _cfg("broken")
    _, nt = jhx.build_nonthermal_table(cfg, n_gamma_nodes=32, n_mu_nodes=16)
    jt = _jax_table(jax_arrays)
    jt = jt.replace(nonthermal=jnp.asarray(nt))
    tt = convert.xsec_table_from_numpy(*jax_arrays, nonthermal=nt)
    rng = np.random.default_rng(1)
    # in-table lanes, cold (below the theta floor) lanes, and lanes past the
    # high eps' and theta edges (the direct-quadrature recompute)
    e = np.concatenate([10.0 ** rng.uniform(-11.5, 5.5, 200), [1e-3, 1.0, 10.0 ** 6.5, 1e-3]])
    theta = np.concatenate([10.0 ** rng.uniform(-3.9, 3.9, 200), [1e-5, 1e-6, 0.1, 10.0 ** 4.5]])
    temp = theta / KB_OVER_MEC2
    want = np.asarray(jhx.interp_thermal(jt, jnp.asarray(e), jnp.asarray(temp)))
    got = thx.interp_thermal(tt, torch.from_numpy(e), torch.from_numpy(temp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9)
    want_nt = np.asarray(jhx.interp_nonthermal(jt, jnp.asarray(e)))
    got_nt = thx.interp_nonthermal(tt, torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(got_nt, want_nt, rtol=1e-12)


@pytest.mark.parametrize("dist", sorted(NT_DISTS))
def test_sub1_fit_and_subgroup_fractions_match_jax(dist):
    cfg = _cfg(dist)
    tcfg = convert.config_from_reference(cfg)
    log_e, nt = jhx.build_nonthermal_table(cfg, n_gamma_nodes=32, n_mu_nodes=16)
    np.testing.assert_allclose(tcs.electron_dist_subgroup_dens(tcfg),
                               jcs.electron_dist_subgroup_dens(cfg), rtol=1e-12)
    np.testing.assert_allclose(thx._sub1_cheb_static(tcfg, log_e, nt[:, 0]),
                               jhx._sub1_cheb_static(cfg, log_e, nt[:, 0]),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("b_field", [BFieldCalc.TOTAL_E, BFieldCalc.INTERNAL_E])
@pytest.mark.parametrize("dist", sorted(NT_DISTS))
def test_nonthermal_electron_densities_match_jax(dist, b_field):
    import dataclasses

    cfg = dataclasses.replace(_cfg(dist), b_field_calc=b_field)
    host, _ = synthetic_spherical_frame(cfg, r_min=1e12, r_max=2e13, nr=24, ntheta=4,
                                        theta_max=np.pi / 3)
    thost = convert.frame_from_numpy_fields(cfg, vars(host))
    tcfg = convert.config_from_reference(cfg)
    want = jcs.nonthermal_electron_dens(cfg, host)
    got = tcs.nonthermal_electron_dens(tcfg, thost)
    assert (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(tcs.b_magnitude(tcfg, thost), np.asarray(jcs.b_magnitude(cfg, host)),
                               rtol=1e-12)
    np.testing.assert_allclose(tcs.dimless_theta(thost.temp), jcs.dimless_theta(host.temp),
                               rtol=1e-15)


def test_distribution_functions_match_jax():
    g = np.geomspace(0.5, 2000.0, 301)
    for p in (2.5, 1.0, 2.0):
        assert tel.power_law_norm(p, 1.0, 100.0) == pytest.approx(
            jel.power_law_norm(p, 1.0, 100.0), rel=1e-14)
        assert tel.norm_power_law_energy_dens(p, 1.0, 100.0) == pytest.approx(
            jel.norm_power_law_energy_dens(p, 1.0, 100.0), rel=1e-14)
        np.testing.assert_allclose(tel.power_law_pdf(g, p, 1.0, 100.0),
                                   np.asarray(jel.power_law_pdf(jnp.asarray(g), p, 1.0, 100.0)),
                                   rtol=1e-12)
        gi = g[(g >= 1.0) & (g <= 100.0)]
        np.testing.assert_allclose(tel.power_law_cdf(gi, p, 1.0, 100.0),
                                   np.asarray(jel.power_law_cdf(jnp.asarray(gi), p, 1.0, 100.0)),
                                   rtol=1e-12, atol=1e-14)
    for p1, p2 in ((1.5, 3.0), (1.0, 3.0), (1.5, 1.0), (2.0, 3.0)):
        args = (p1, p2, 1.0, 1000.0, 10.0)
        assert tel.broken_power_law_norm(*args) == pytest.approx(
            jel.broken_power_law_norm(*args), rel=1e-14)
        assert tel.norm_broken_power_law_energy_dens(*args) == pytest.approx(
            jel.norm_broken_power_law_energy_dens(*args), rel=1e-14)
        np.testing.assert_allclose(tel.broken_power_law_pdf(g, *args),
                                   np.asarray(jel.broken_power_law_pdf(jnp.asarray(g), *args)),
                                   rtol=1e-12)
        gi = g[(g >= 1.0) & (g <= 1000.0)]
        np.testing.assert_allclose(
            tel.broken_power_law_cdf(gi, *args),
            np.asarray(jel.broken_power_law_cdf(jnp.asarray(gi), *args)), rtol=1e-12, atol=1e-14)
        # a CDF ends at 1
        assert tel.broken_power_law_cdf(np.array([1000.0]), *args)[0] == pytest.approx(1.0)


def test_special_functions_match_jax():
    z = np.geomspace(1e-3, 50.0, 401)
    for name in ("bessel_k0e", "bessel_k1e", "bessel_k2e"):
        want = np.asarray(getattr(jsp, name)(jnp.asarray(z)))
        np.testing.assert_allclose(getattr(tsp, name)(z), want, rtol=1e-13)
        np.testing.assert_allclose(getattr(tsp, name)(torch.from_numpy(z)).numpy(), want,
                                   rtol=1e-13)
    theta = np.geomspace(1e-4, 1e4, 33)[:, None]
    gamma = 1.0 + 12.0 * theta * np.linspace(0.01, 0.99, 17)[None, :]
    np.testing.assert_allclose(tsp.maxwell_juttner_pdf(gamma, theta),
                               np.asarray(jsp.maxwell_juttner_pdf(jnp.asarray(gamma),
                                                                  jnp.asarray(theta))),
                               rtol=1e-12)


def test_frame_host_packs_nonthermal_density():
    """The nonthermal density set on a host frame lands in the packed row the
    kernel reads (grid.PCOL['nonthermal_dens'])."""
    from mcrat_tpu_torch.grid import PCOL
    from mcrat_tpu_torch.grid import frame_from_numpy as tframe_from_numpy
    from mcrat_tpu_torch.models.analytic import make_grid_2d

    tcfg = convert.config_from_reference(_cfg("powerlaw"))
    host = tframe_from_numpy(tcfg, make_grid_2d(tcfg, np.linspace(0, 1e11, 5),
                                                np.linspace(1e12, 2e12, 9)))
    host.nonthermal_dens = tcs.nonthermal_electron_dens(tcfg, host)
    frame = host.to_device("cpu")
    np.testing.assert_array_equal(frame.packed[PCOL["nonthermal_dens"]].numpy(),
                                  host.nonthermal_dens.astype(np.float32))
    assert (host.nonthermal_dens > 0).all()
