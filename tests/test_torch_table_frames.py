"""TABLE-mode frames through the port (CPU, plain twin) against mcrat_tpu.

The frame of tests/test_pallas_round.py::test_fused_table_mode_matches_xla:
the hot 32x64 cylinder (T' = 5e8 K, sigma_hat measurably below Thomson).
The port's glue (``transport_rounds_fused`` with ``xsec_table``: per-cell
Chebyshev rows, sigma_hat rebuilt every round in the kernel) is held in
distribution against JAX's XLA engine (``transport_rounds`` with the same
table, interpolated bilinearly) with that test's tolerances: the two draw
different random numbers.  DIRECT still scatters > 1.1 x as often.  The
whole frame (``transport_frame``: 8-round chunks and compaction) against
JAX's ``transport_frame(fused=False)`` with tests/test_torch_transport_frame's
hot-frame tolerances.

The port gets JAX's float64 table arrays (``convert.xsec_table_from_numpy``);
JAX's engine reads them as float32, as in bench.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.config import Config, Dims, Geometry, SimType, Spectrum, TauCalculation
from mcrat_tpu.grid import build_rectilinear_index, frame_from_numpy
from mcrat_tpu.models.analytic import apply_simulation_type, make_grid_2d
from mcrat_tpu.ops import hot_xsec as jhx
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.ops import fused_round as fr

torch.set_num_threads(1)

CFG = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL, dtype="float32",
             simulation_type=SimType.CYLINDRICAL_OUTFLOW, tau_calculation=TauCalculation.TABLE)
EDGES = (np.linspace(0.0, 3.2e11, 33), np.linspace(1.8e12, 2.9e12, 65))
TCFG = convert.config_from_reference(CFG)


@pytest.fixture(scope="module")
def hot_frame(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("xsec") / "th.npz")
    tab64 = jhx.load_or_build(CFG, path, dtype="float64")
    tab32 = jhx.load_or_build(CFG, path, dtype="float32")  # the cache, as float32
    xsec = convert.xsec_table_from_numpy(tab64.log_e, tab64.log_t, tab64.thermal)
    host = frame_from_numpy(CFG, make_grid_2d(CFG, *EDGES))
    apply_simulation_type(host)
    host.temp[:] = 5e8
    arrays, _ = jt.inject_photons(
        host, r_inj=2e12, ph_weight=1e50, min_photons=1500, max_photons=4000,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 30, fps=5.0,
        rng=np.random.default_rng(23))
    photons, _ = jt.photons_from_arrays(arrays, capacity=4096, dtype=jnp.float32)
    return host, photons, tab32, xsec


def _stats(d, n_scatt):
    alive = (d["weight"] > 0) & (d["ptype"] != 5)
    return dict(w=float(d["weight"].sum()), e=d["p"][alive, 0].mean(),
                ns=d["num_scatt"][alive].mean(),
                r=np.linalg.norm(d["pos"], axis=1)[alive].mean(), n_scatt=int(n_scatt))


def _port(host, photons):
    return (convert.photons_from_numpy({k: np.asarray(v) for k, v in vars(photons).items()}, device="cpu"),
            convert.frame_from_numpy_fields(CFG, vars(host)).to_device("cpu"),
            convert.index_from_edges(*EDGES, device="cpu"))


def test_table_rounds_match_xla(hot_frame):
    host, photons, tab32, xsec = hot_frame
    t_rem = jt.frame_time(photons, jnp.float32(0.05))
    res_x = jt.transport_rounds(CFG, photons, host.to_device(dtype=jnp.float32),
                                build_rectilinear_index(*EDGES, dtype="float32"), t_rem,
                                make_key(9), xsec_table=tab32, max_rounds=16)
    tph, tframe, tidx = _port(host, photons)
    setup = tt.select_variant(TCFG, tframe, tidx, xsec)
    assert setup.variant == "ultra_cyl2" and setup.cheb_base == 4
    assert setup.table.shape[0] == 4 + 16
    launches = fr.fused_rounds.launches
    t0 = torch.from_numpy(np.array(t_rem))
    res_t = tt.transport_rounds_fused(TCFG, tph, tframe, tidx, t0, base_seed=9,
                                      setup=setup, max_rounds=16,
                                      inner_rounds=2, s_rows=8)
    assert fr.fused_rounds.launches == launches  # CPU: the twin, never the kernel
    a = _stats({k: np.asarray(v) for k, v in vars(res_x.photons).items()}, res_x.n_scatt)
    b = _stats(convert.photons_to_numpy(res_t.photons), res_t.n_scatt)
    assert b["w"] == pytest.approx(a["w"], rel=1e-6)
    assert b["n_scatt"] == pytest.approx(a["n_scatt"], rel=0.12)
    assert b["ns"] == pytest.approx(a["ns"], rel=0.12)
    assert b["e"] == pytest.approx(a["e"], rel=0.15)
    assert b["r"] == pytest.approx(a["r"], rel=1e-3)
    # the hot suppression is real: DIRECT (sigma_hat = 1) scatters more
    direct = convert.config_from_reference(
        Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL, dtype="float32",
               simulation_type=SimType.CYLINDRICAL_OUTFLOW))
    res_d = tt.transport_rounds_fused(direct, tph, tframe, tidx, t0, base_seed=9,
                                      setup=tt.select_variant(direct, tframe, tidx),
                                      max_rounds=16, inner_rounds=2, s_rows=8)
    assert int(res_d.n_scatt) > 1.1 * b["n_scatt"]


def test_table_frame_matches_xla(hot_frame):
    host, photons, tab32, xsec = hot_frame
    res_x = jt.transport_frame(CFG, photons, host.to_device(dtype=jnp.float32),
                               build_rectilinear_index(*EDGES, dtype="float32"),
                               jnp.float32(0.05), make_key(1), xsec_table=tab32, fused=False)
    tph, tframe, tidx = _port(host, photons)
    res_t = tt.transport_frame(TCFG, tph, tframe, tidx, 0.05, torch.Generator().manual_seed(1),
                               fused=True, chunk_rounds=8, s_rows=8, xsec_table=xsec)
    assert res_t.n_rounds > 8  # several chunks
    alive = res_t.photons.alive
    assert (res_t.t_rem[alive] <= 0).all()
    assert torch.equal(res_t.photons.weight, tph.weight)
    a = _stats({k: np.asarray(v) for k, v in vars(res_x.photons).items()}, res_x.n_scatt)
    b = _stats(convert.photons_to_numpy(res_t.photons), res_t.n_scatt)
    assert b["n_scatt"] == pytest.approx(a["n_scatt"], rel=0.12)
    assert b["ns"] == pytest.approx(a["ns"], rel=0.1)
    assert b["e"] == pytest.approx(a["e"], rel=0.15)
    assert b["r"] == pytest.approx(a["r"], rel=1e-3)
