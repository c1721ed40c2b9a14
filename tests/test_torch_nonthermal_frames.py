"""Nonthermal frames through the port (CPU, plain twin) against mcrat_tpu.

The frame of tests/test_pallas_round.py::test_fused_nonthermal_matches_xla:
a 96x16 spherical outflow with bench.py's power law (p = 2.5, gamma 1-100,
3 subgroups), the nonthermal density from the equipartition B field.  The
port's glue (``transport_rounds_fused``: biased population draw and
subgroup inverse-CDF gamma in the kernel, the subgroup-1 fallback from its
global Chebyshev fit) is held in distribution against JAX's XLA engine
(``transport_rounds``: per-subgroup interpolated tables) with that test's
tolerances.  The port gets JAX's float64 tables; JAX's engine reads them as
float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.config import (
    Config, Dims, Geometry, NonthermalDist, SimType, Spectrum, TauCalculation,
)
from mcrat_tpu.grid import build_rectilinear_index
from mcrat_tpu.models.analytic import synthetic_spherical_frame
from mcrat_tpu.ops import cyclosynch as jcs
from mcrat_tpu.ops import hot_xsec as jhx
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.ops import cyclosynch as tcs

torch.set_num_threads(1)


def test_nonthermal_rounds_match_xla(tmp_path):
    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL, dtype="float32",
                 simulation_type=SimType.SPHERICAL_OUTFLOW, tau_calculation=TauCalculation.TABLE,
                 nonthermal_e_dist=NonthermalDist.POWERLAW, powerlaw_index=2.5, gamma_min=1.0,
                 gamma_max=100.0)
    path = str(tmp_path / "nt.npz")
    tab64 = jhx.load_or_build(cfg, path, dtype="float64")
    tab32 = jhx.load_or_build(cfg, path, dtype="float32")
    xsec = convert.xsec_table_from_numpy(tab64.log_e, tab64.log_t, tab64.thermal,
                                         tab64.nonthermal, tab64.subgroup_frac)
    host, edges = synthetic_spherical_frame(cfg, r_min=1e12, r_max=2e13, nr=96, ntheta=16,
                                            theta_max=np.pi / 3)
    host.nonthermal_dens = jcs.nonthermal_electron_dens(cfg, host)
    assert (host.nonthermal_dens > 0).all()
    arrays, _ = jt.inject_photons(
        host, r_inj=4e12, ph_weight=1e50, min_photons=2000, max_photons=6000,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 6, fps=5.0,
        rng=np.random.default_rng(29))
    photons, _ = jt.photons_from_arrays(arrays, capacity=None, dtype=jnp.float32)
    t_rem = jt.frame_time(photons, jnp.float32(0.3))
    res_x = jt.transport_rounds(cfg, photons, host.to_device(dtype=jnp.float32),
                                build_rectilinear_index(*edges, dtype="float32"), t_rem,
                                make_key(13), xsec_table=tab32, max_rounds=20)
    thost = convert.frame_from_numpy_fields(cfg, vars(host))
    tcfg = convert.config_from_reference(cfg)
    np.testing.assert_allclose(tcs.nonthermal_electron_dens(tcfg, thost), host.nonthermal_dens,
                               rtol=1e-12)
    tph = convert.photons_from_numpy({k: np.asarray(v) for k, v in vars(photons).items()}, device="cpu")
    tframe, tidx = thost.to_device("cpu"), convert.index_from_edges(*edges, device="cpu")
    setup = tt.select_variant(tcfg, tframe, tidx, xsec)
    assert setup.variant == "packed_sph2" and setup.cheb_base == 16 and setup.nt is not None
    res_t = tt.transport_rounds_fused(tcfg, tph, tframe, tidx, torch.from_numpy(np.array(t_rem)),
                                      base_seed=13, setup=setup, max_rounds=20, inner_rounds=2,
                                      s_rows=8)

    def stats(d, n_scatt):
        alive = (d["weight"] > 0) & (d["ptype"] != 5)
        return dict(w=float(d["weight"].sum()), e=d["p"][alive, 0].mean(),
                    ns=d["num_scatt"][alive].mean(),
                    r=np.linalg.norm(d["pos"], axis=1)[alive].mean(), n_scatt=int(n_scatt))

    a = stats({k: np.asarray(v) for k, v in vars(res_x.photons).items()}, res_x.n_scatt)
    b = stats(convert.photons_to_numpy(res_t.photons), res_t.n_scatt)
    assert b["w"] == pytest.approx(a["w"], rel=1e-6)
    assert b["n_scatt"] == pytest.approx(a["n_scatt"], rel=0.15)
    assert b["ns"] == pytest.approx(a["ns"], rel=0.15)
    # gamma <= 100 nonthermal electrons upscatter: mean energies must track
    assert b["e"] == pytest.approx(a["e"], rel=0.25)
    assert b["r"] == pytest.approx(a["r"], rel=1e-3)
    assert all(bool(torch.isfinite(x).all()) for x in (res_t.photons.p, res_t.photons.pos))
