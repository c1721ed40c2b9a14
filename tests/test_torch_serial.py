"""The port's serial oracle (``mcrat_tpu_torch.serial``) on the CPU, against
the JAX package's (``mcrat_tpu.serial``).

* ``Key.randint`` bit for bit ``jax.random.randint`` (int64 and int32; the
  oracle seeds its numpy generator with it).
* Fault F4 (not copied): the JAX oracle's K2(x) e^x on its fixed t-grid
  against the large-x asymptotic series, and the port's (scipy's ``kve``)
  within 1e-10 relative.
* ``transport_frame_serial`` lane for lane against JAX's in float64, with
  the same threefry key, for a capped number of events, on
  tests/test_serial_equivalence.py's frames: DIRECT (Stokes on); TABLE with
  power-law electrons (the independent numpy quadrature, the host-side
  population pick); the same with the deliberately broken bias.  Event
  counts, scatterings, types and cells exact, the frame time consumed to
  rtol 1e-12, continuous fields to rtol 1e-9 of the vector's scale, Stokes
  per lane to 1e-12 plus what its rotations may add (as
  tests/test_torch_xla_rounds.py bounds it).
* tests/test_serial_equivalence.py's two checks on the port: its batched
  XLA engine against its oracle in distribution, and the oracle telling the
  broken bias apart by its scattering rate.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import serial as jserial
from mcrat_tpu import transport as jt
from mcrat_tpu.config import (Config, Dims, Geometry, NonthermalDist, SimType, Spectrum,
                              TauCalculation)
from mcrat_tpu.grid import frame_from_numpy
from mcrat_tpu.models.analytic import apply_simulation_type, make_grid_2d
from mcrat_tpu.ops import cyclosynch as jcs
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import serial as tserial
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.ops import hot_xsec as thx
from mcrat_tpu_torch.ops import prng
from mcrat_tpu_torch.ops import stokes as tstokes

from test_torch_xla_rounds import ROTATION_DELTA, _compare_lanes

torch.set_num_threads(1)

CFG = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
             simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float64")
NT_CFG = dataclasses.replace(CFG, tau_calculation=TauCalculation.TABLE,
                             nonthermal_e_dist=NonthermalDist.POWERLAW, powerlaw_index=2.5,
                             gamma_min=1.0, gamma_max=100.0)


@pytest.mark.parametrize("seed", [0, 22, 40507, 2**40 + 5])
def test_randint_matches_jax(seed):
    jk = jax.random.fold_in(make_key(seed, impl="threefry2x32"), 40507)
    tk = prng.Key.from_seed(seed).fold_in(40507)
    for shape, lo, hi in [((), 0, 2**31 - 1), ((7,), -5, 100), ((3, 4), 0, 65537),
                          ((5,), 3, 3), ((6,), 0, 2**20 + 3)]:
        for dtype, bits in ((jnp.int64, 64), (jnp.int32, 32)):
            want = np.asarray(jax.random.randint(jk, shape, lo, hi, dtype=dtype))
            got = tk.randint(shape, lo, hi, bits=bits)
            np.testing.assert_array_equal(got.numpy(), want)
    assert int(tk.randint((), 0, 2**31 - 1)) == int(
        jax.random.randint(jk, (), 0, 2**31 - 1))  # the default: int64 under x64


def _k2e_asymptotic(x):
    """K2(x) e^x by its large-x series, sqrt(pi / 2x) sum_k a_k / x^k,
    a_k = prod_{j<=k} (16 - (2j - 1)^2) / (k! 8^k); six terms leave < 1e-25
    at x >= 1e5."""
    total, term = 1.0, 1.0
    for k in range(1, 7):
        term *= (16.0 - (2 * k - 1) ** 2) / (k * 8.0 * x)
        total += term
    return np.sqrt(np.pi / (2.0 * x)) * total


def test_f4_k2e_in_cold_cells():
    """At x = m_e c^2 / kT = 1e5 (59 K) the JAX oracle's fixed t-grid still
    holds (5e-12); at 1e6 (5.9 K) and 1e7 (0.59 K) the integrand's width
    sqrt(2 / x) falls under its step and its K2 e^x is off by 3e-4 and 0.9.
    The port's is within 1e-10 at every x."""
    xs = np.array([1e5, 1e6, 1e7])
    want = np.array([_k2e_asymptotic(x) for x in xs])
    port = np.abs(tserial._k2e_np(xs) / want - 1.0)
    jax_err = np.abs(jserial._k2e_np(xs) / want - 1.0)
    assert (port < 1e-10).all(), port
    assert jax_err[0] < 1e-10 and (jax_err[1:] > 1e-4).all(), jax_err
    # and in warm cells the two agree to rounding
    warm = np.array([1e-2, 1.0, 10.0, 1e3])
    np.testing.assert_allclose(tserial._k2e_np(warm), jserial._k2e_np(warm), rtol=1e-13)


class _Problem:
    """tests/test_serial_equivalence.py's uniform cylindrical outflow in both
    packages (float64)."""

    def __init__(self, cfg, nr, nz, n_min, n_max, seed, hot=False):
        r0_edges = np.linspace(0.0, 3.2e11, nr + 1)
        r1_edges = np.linspace(1.8e12, 2.6e12, nz + 1)
        host = frame_from_numpy(cfg, make_grid_2d(cfg, r0_edges, r1_edges))
        apply_simulation_type(host)
        if hot:
            host.temp[:] = 5e8  # sigma_hat measurably below Thomson
            host.pres[:] = host.temp**4 * 7.5657e-15 / 3.0
            host.nonthermal_dens = jcs.nonthermal_electron_dens(cfg, host)
        self.arrays, _ = jt.inject_photons(
            host, r_inj=2e12, ph_weight=1e50, min_photons=n_min, max_photons=n_max,
            spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 30, fps=5.0,
            rng=np.random.default_rng(seed))
        self.jcfg, self.tcfg = cfg, convert.config_from_reference(cfg)
        self.jframe = host.to_device(dtype=jnp.float64)
        from mcrat_tpu.grid import build_rectilinear_index

        self.jidx = build_rectilinear_index(r0_edges, r1_edges)
        self.tframe = convert.frame_from_numpy_fields(cfg, vars(host)).to_device(
            "cpu", dtype=torch.float64)
        self.tidx = convert.index_from_edges(r0_edges, r1_edges, dtype=torch.float64,
                                             device="cpu")
        self.jph, _ = jt.photons_from_arrays(self.arrays, capacity=None, dtype=jnp.float64)
        self.tph, _ = tt.photons_from_arrays(self.arrays, dtype=torch.float64, device="cpu",
                                             weight_norm=float(np.median(self.arrays["weight"])))


_PROBLEMS = {}


def problem(kind):
    if kind not in _PROBLEMS:
        _PROBLEMS[kind] = (_Problem(CFG, 64, 128, 300, 1200, 0) if kind == "direct" else
                           _Problem(NT_CFG, 32, 64, 150, 600, 5, hot=True))
    return _PROBLEMS[kind]


class AttemptRotations:
    """Per photon, the Stokes error float64 rounding may build up in the
    rotations of its scatter attempts (tests/test_torch_xla_rounds.py's
    ``RotationErrors`` bound, photon by photon: each attempt's rotations
    are charged to the photon it scatters), here without that bound's
    exemption of f == 0: on this outflow along z-hat the first rotation of
    a boost compares z-hat with the fluid velocity, so d = +-1 to rounding
    and f = the sign of a rounding error; one package may take the identity
    (f = 0) where the other rotates by sqrt(2 ulp), and min(delta /
    sqrt(1 - d^2), sqrt(delta)) bounds both."""

    def __init__(self, monkeypatch, n):
        self.bound = torch.full((n,), 1e-12, dtype=torch.float64)
        self.idx = None
        rotation, attempt = tstokes._rotation_cs, tserial._attempt_core

        def record(d, f):
            cond = torch.sqrt(torch.clamp(1.0 - d * d, min=0.0))
            err = torch.clamp(ROTATION_DELTA / cond, max=ROTATION_DELTA ** 0.5)
            self.bound[self.idx] += float(err.max())
            return rotation(d, f)

        def attempt_core(cfg, photons, frame, idx, *a, **k):
            self.idx = idx
            return attempt(cfg, photons, frame, idx, *a, **k)

        monkeypatch.setattr(tstokes, "_rotation_cs", record)
        monkeypatch.setattr(tserial, "_attempt_core", attempt_core)


@pytest.mark.parametrize("kind,break_bias,events", [("direct", False, 120),
                                                    ("nonthermal", False, 60),
                                                    ("nonthermal", True, 40)])
def test_serial_oracle_lane_for_lane(kind, break_bias, events, monkeypatch):
    p = problem(kind)
    rotations = AttemptRotations(monkeypatch, p.tph.capacity)
    dt = 0.03 if kind == "direct" else 0.006
    got = tserial.transport_frame_serial(p.tcfg, p.tph, p.tframe, p.tidx, dt,
                                         prng.Key.from_seed(22), max_events=events,
                                         break_bias=break_bias)
    want = jserial.transport_frame_serial(p.jcfg, p.jph, p.jframe, p.jidx, dt,
                                          make_key(22, impl="threefry2x32"), max_events=events,
                                          break_bias=break_bias)
    assert got.n_events_attempted == want.n_events_attempted
    assert got.n_scatt == want.n_scatt > 5
    np.testing.assert_allclose(got.t_advanced, want.t_advanced, rtol=1e-12)
    _compare_lanes(got.photons, want.photons, stokes_bound=rotations.bound)
    # the caller's photons were not written
    np.testing.assert_array_equal(p.tph.pos.numpy(), p.arrays["pos"])


def test_batched_matches_serial_statistics():
    """tests/test_serial_equivalence.py's first check on the port: its XLA
    engine and its oracle on the same population, event counts within 5
    sigma, mean energy within 5 %, mean scatterings within 5 standard
    errors, mean radius within 1e-3."""
    p = problem("direct")
    dt = 0.03
    res_b = tt.transport_frame(p.tcfg, p.tph, p.tframe, p.tidx, dt, fused=False,
                               key=prng.Key.from_seed(11))
    res_s = tserial.transport_frame_serial(p.tcfg, p.tph, p.tframe, p.tidx, dt,
                                           prng.Key.from_seed(22))
    nb, ns = res_b.n_scatt, res_s.n_scatt
    assert nb > 50 and ns > 50
    assert abs(nb - ns) < 5.0 * np.sqrt(nb + ns), (nb, ns)
    e_b = float(tt.average_photon_energy(res_b.photons))
    e_s = float(tt.average_photon_energy(res_s.photons))
    assert abs(e_b - e_s) / e_s < 0.05
    ns_b, ns_s = res_b.photons.num_scatt.numpy(), res_s.photons.num_scatt.numpy()
    se = np.sqrt(ns_b.var() / len(ns_b) + ns_s.var() / len(ns_s))
    assert abs(ns_b.mean() - ns_s.mean()) < 5.0 * se + 1e-9
    r_b = res_b.photons.pos.norm(dim=1).mean().item()
    r_s = res_s.photons.pos.norm(dim=1).mean().item()
    assert abs(r_b - r_s) / r_s < 1e-3


@pytest.mark.slowish
def test_serial_oracle_table_nonthermal_and_bias_discrimination(tmp_path):
    """tests/test_serial_equivalence.py's second check on the port: the
    oracle's independent TABLE + nonthermal machinery agrees with the port's
    XLA engine on the scattering count (5 sigma), both reach large
    nonthermal upscatters, and the broken bias is told apart by its
    scattering rate (orders of magnitude, far beyond 3 sigma)."""
    p = problem("nonthermal")
    table = thx.load_or_build(p.tcfg, str(tmp_path / "x.npz"), device="cpu")
    dt = 0.006
    res_b = tt.transport_frame(p.tcfg, p.tph, p.tframe, p.tidx, dt, fused=False,
                               key=prng.Key.from_seed(11), xsec_table=table)
    res_s = tserial.transport_frame_serial(p.tcfg, p.tph, p.tframe, p.tidx, dt,
                                           prng.Key.from_seed(22))
    nb, ns = res_b.n_scatt, res_s.n_scatt
    assert nb > 25 and ns > 25, (nb, ns)
    assert abs(nb - ns) < 5.0 * np.sqrt(nb + ns), (nb, ns)

    def max_gain(res):
        e0 = p.tph.comv_p[:, 0].numpy()
        e1 = res.photons.comv_p[:, 0].numpy()
        return float(np.max(e1 / np.maximum(e0, 1e-300)))

    assert max_gain(res_b) > 3.0 and max_gain(res_s) > 3.0
    broken = tserial.transport_frame_serial(p.tcfg, p.tph, p.tframe, p.tidx, dt,
                                            prng.Key.from_seed(22), break_bias=True,
                                            max_events=250)
    assert broken.t_advanced > 0
    rate_ok = ns / res_s.t_advanced
    rate_broken = broken.n_scatt / broken.t_advanced
    assert rate_broken > 10.0 * rate_ok, (rate_broken, rate_ok)
