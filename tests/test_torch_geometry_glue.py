"""The port's fused glue on spherical and 3-D frames against JAX's.

``mcrat_tpu_torch.transport.transport_rounds_fused`` (the plain twin on CPU
tensors) against ``mcrat_tpu.transport.transport_rounds_fused(...,
interpret=True)`` on the problems of tests/test_pallas_round.py: the 2-D
spherical outflow on a log-r grid (packed_sph2), and the 3-D spherical
(packed_sph3, a 24-row table) and polar (packed_pol3) outflows.  Both draw
the same counter stream from the same base seed.  Every 5th photon is a CS
pool photon.

Each problem runs twice.  At a uniform T' = 1e5 K the discrete state is held
lane for lane (scatter counts and cells on >= 99.9 % of photons; the cell
lookup's float32 arccos/atan2 may put a photon on a face in the other cell),
positions per lane to 1e-4 of their radius, and the rest in aggregate, as
tests/test_torch_fused_round.py does for the flagship frame.  At the
problems' own temperatures (1e6-6e6 K) the comoving photon energies fall in
1e-3 < eps < 1e-2, where the float32 Klein-Nishina formula that both kernels
share (pallas_round._kn_cross_section) cancels to ~1e-2 absolute error
(ROADMAP queue 3, F6): XLA-CPU and torch round it differently and ~1 % of
scatter acceptances flip.  That run is held to >= 97 % identical scatter
counts and to aggregates.  On the card the kernel and the twin share their
math functions and agree bit for bit (chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_geometry_cases import S_ROWS, jax_problem, to_port
from mcrat_tpu import transport as jt
from mcrat_tpu.config import PhotonType
from mcrat_tpu.grid import build_rectilinear_index
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt

torch.set_num_threads(1)


def run_both(kind, cold):
    cfg, host, edges, photons, dt = jax_problem(kind, cold)
    ptype = np.asarray(photons.ptype).copy()
    ptype[::5] = int(PhotonType.CS_POOL)
    photons = photons.replace(ptype=jnp.asarray(ptype))
    t_rem = jt.frame_time(photons, jnp.float32(dt))
    key = make_key(2)
    res = jt.transport_rounds_fused(
        cfg, photons, host.to_device(dtype=jnp.float32),
        build_rectilinear_index(*edges, dtype="float32"), t_rem, key, max_rounds=8,
        inner_rounds=2, s_rows=S_ROWS, interpret=True)
    base_seed = int(jax.random.randint(key, (), jnp.iinfo(jnp.int32).min,
                                       jnp.iinfo(jnp.int32).max, dtype=jnp.int32))
    tframe, tidx, tph = to_port(cfg, host, edges, photons)
    tcfg = convert.config_from_reference(cfg)
    tres = tt.transport_rounds_fused(tcfg, tph, tframe, tidx, torch.from_numpy(np.array(t_rem)),
                                     base_seed=base_seed,
                                     setup=tt.select_variant(tcfg, tframe, tidx),
                                     max_rounds=8, inner_rounds=2, s_rows=S_ROWS)
    assert tres.n_rounds == int(res.n_rounds) <= 8
    a = {k: np.asarray(v) for k, v in vars(res.photons).items()}
    b = convert.photons_to_numpy(tres.photons)
    live = a["weight"] > 0
    return a, b, live, int(res.n_scatt), int(tres.n_scatt), res.t_rem, tres.t_rem


@pytest.mark.parametrize("kind", ["spherical_2d", "spherical_3d", "polar_3d"])
def test_glue_matches_jax_fused_transport(kind):
    for cold in (True, False):
        a, b, live, jn, tn, jt_rem, tt_rem = run_both(kind, cold)
        n = live.sum()
        same = (a["num_scatt"] == b["num_scatt"]) & live
        assert same.sum() >= (0.999 if cold else 0.97) * n, (cold, n - same.sum(), n)
        assert (a["cell"] == b["cell"])[live].sum() >= 0.999 * n
        assert (a["cell"][same] == b["cell"][same]).mean() >= 0.999
        np.testing.assert_array_equal(a["weight"], b["weight"])
        np.testing.assert_array_equal(a["ptype"][same], b["ptype"][same])
        assert (b["ptype"] == int(PhotonType.COMPTONIZED)).any()  # pool promotion ran
        assert jn > 200
        assert tn == pytest.approx(jn, rel=1e-3 if cold else 2e-2)
        dpos = np.linalg.norm(a["pos"] - b["pos"], axis=1)
        assert (dpos[same] <= 1e-4 * np.linalg.norm(a["pos"], axis=1)[same]).all()
        for k, col in (("p", 0), ("comv_p", 0)):
            assert b[k][same, col].mean() == pytest.approx(a[k][same, col].mean(), rel=1e-3)
        for col in (1, 2):
            assert abs(b["s"][live, col].mean() - a["s"][live, col].mean()) < 0.01
        assert ((tt_rem.numpy() > 0) == (np.asarray(jt_rem) > 0))[live].mean() >= 0.999
