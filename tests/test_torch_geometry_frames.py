"""Whole spherical and 3-D frames through the port against mcrat_tpu.

The port's ``transport_frame`` (fused glue, chunked, with compaction, the
plain twin on CPU tensors) is held in distribution against JAX's XLA engine
(``transport_frame(fused=False)``, i.e. ``transport_rounds``) on the 2-D
spherical, 3-D spherical and 3-D polar problems of tests/test_pallas_round.py
and a cut of bench.py's 3-D cartesian frame, with that file's tolerances
(:94-101 in 2-D, :345-350 in 3-D): the two engines draw different random
numbers.

Fault F1 on the 3-D path (ROADMAP queue 3): JAX's fused kernel drops the
z -> beta_e Stokes rotations where the fluid velocity is zero.  The port
repairs it in every variant, so on a v = 0 3-D cartesian frame its mean Q/U
after one scattering match JAX's ``transport_rounds`` within 4 sigma of the
Monte Carlo error.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_geometry_cases import frame_case, jax_problem, to_port
from mcrat_tpu import transport as jt
from mcrat_tpu.grid import build_rectilinear_index
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.ops import fused_round as fr

torch.set_num_threads(1)


def _stats(d, n_scatt):
    alive = (d["weight"] > 0) & (d["ptype"] != 5)
    s = d["s"][alive]
    return dict(w=float(d["weight"].sum()), e=d["p"][alive, 0].mean(),
                ns=d["num_scatt"][alive].mean(),
                r=np.linalg.norm(d["pos"], axis=1)[alive].mean(),
                q=float(s[:, 1].mean()), u=float(s[:, 2].mean()), n_scatt=int(n_scatt))


@pytest.mark.parametrize("kind,variant", [
    ("spherical_2d", "packed_sph2"), ("cartesian_3d", "ultra_cart3"),
    ("spherical_3d", "packed_sph3"), ("polar_3d", "packed_pol3"),
])
def test_transport_frame_matches_xla(kind, variant):
    cfg, host, edges, photons, dt = jax_problem(kind)
    res_x = jt.transport_frame(cfg, photons, host.to_device(dtype=jnp.float32),
                               build_rectilinear_index(*edges, dtype="float32"),
                               jnp.float32(dt), make_key(1), fused=False)
    tframe, tidx, tph = to_port(cfg, host, edges, photons)
    tcfg = convert.config_from_reference(cfg)
    assert tt.select_variant(tcfg, tframe, tidx).variant == variant
    launches = fr.fused_rounds.launches
    res_t = tt.transport_frame(tcfg, tph, tframe, tidx, dt, torch.Generator().manual_seed(1),
                               fused=True, chunk_rounds=8, s_rows=8)
    assert fr.fused_rounds.launches == launches  # CPU: the twin, never the kernel
    alive = res_t.photons.alive
    assert (res_t.t_rem[alive] <= 0).all()
    assert torch.equal(res_t.photons.weight, tph.weight)
    assert all(bool(torch.isfinite(x).all()) for x in (res_t.photons.p, res_t.photons.pos))
    a = _stats({k: np.asarray(v) for k, v in vars(res_x.photons).items()}, res_x.n_scatt)
    b = _stats(convert.photons_to_numpy(res_t.photons), res_t.n_scatt)
    three_d = kind != "spherical_2d"
    assert a["n_scatt"] > 300
    assert b["w"] == pytest.approx(a["w"], rel=1e-6)
    assert b["n_scatt"] == pytest.approx(a["n_scatt"], rel=0.15 if three_d else 0.12)
    assert b["ns"] == pytest.approx(a["ns"], rel=0.15 if three_d else 0.1)
    assert b["e"] == pytest.approx(a["e"], rel=0.1 if three_d else 0.08)
    assert b["r"] == pytest.approx(a["r"], rel=1e-3)
    if not three_d:
        assert abs(b["q"] - a["q"]) < 0.05
        assert abs(b["u"] - a["u"]) < 0.05


def test_f1_zero_velocity_polarization_3d_matches_xla():
    """v = 0 3-D cartesian frame (the ultra_cart3 variant), an unpolarized
    beam tilted 0.3 rad off the z axis, one scattering each: mean Q/U match
    transport_rounds within 4 sigma."""
    cfg, host, edges, _ = frame_case("ultra_cart3", gamma=1.0)
    assert not (host.v0.any() or host.v1.any() or host.v2.any())
    n = 4096
    rs = np.random.default_rng(9)
    e = np.full(n, 5e-5)
    d = np.array([np.sin(0.3), 0.0, np.cos(0.3)])
    p = np.concatenate([e[:, None], e[:, None] * d[None]], axis=1)
    pos = np.stack([rs.uniform(-3e11, 3e11, n), rs.uniform(-3e11, 3e11, n),
                    rs.uniform(2.0e12, 2.6e12, n)], axis=1)
    s = np.zeros((n, 4))
    s[:, 0] = 1.0
    arrays = dict(p=p, comv_p=p.copy(), pos=pos, s=s, weight=np.ones(n),
                  num_scatt=np.zeros(n), cell=np.full(n, -1, np.int32),
                  ptype=np.zeros(n, np.int32))
    photons, _ = jt.photons_from_arrays(arrays, capacity=None, dtype=jnp.float32)
    t_rem = jt.frame_time(photons, jnp.float32(1e-2))
    res_x = jt.transport_rounds(cfg, photons, host.to_device(dtype=jnp.float32),
                                build_rectilinear_index(*edges, dtype="float32"), t_rem,
                                make_key(3), max_rounds=1)
    tframe, tidx, tph = to_port(cfg, host, edges, photons)
    tcfg = convert.config_from_reference(cfg)
    assert tt.select_variant(tcfg, tframe, tidx).variant == "ultra_cart3"
    res_t = tt.transport_rounds_fused(tcfg, tph, tframe, tidx, torch.from_numpy(np.array(t_rem)),
                                      base_seed=77, setup=tt.select_variant(tcfg, tframe, tidx),
                                      max_rounds=1, inner_rounds=1, s_rows=8)

    def once(ph):
        m = ph["num_scatt"] == 1
        return ph["s"][m, 1], ph["s"][m, 2]

    qa, ua = once({k: np.asarray(v) for k, v in vars(res_x.photons).items()})
    qb, ub = once(convert.photons_to_numpy(res_t.photons))
    assert len(qa) > 0.9 * n and len(qb) > 0.9 * n
    for a, b in ((qa, qb), (ua, ub)):
        sigma = np.sqrt(a.var() / len(a) + b.var() / len(b))
        assert abs(a.mean() - b.mean()) < 4 * sigma, (a.mean(), b.mean(), sigma)
    # the beam's scattered polarization is strong, so a basis error shows
    assert qa.mean() > 20 * np.sqrt(qa.var() / len(qa))
