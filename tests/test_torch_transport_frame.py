"""Whole frames through the port (CPU, plain twin) against mcrat_tpu.

The port's ``transport_frame`` (fused glue, chunked, with compaction) is held
in distribution against JAX's XLA engine (``transport_frame(fused=False)``)
on the small cylindrical problem of tests/test_pallas_round.py and its hot
variant, with that file's tolerances: the two draw different random numbers.

Fault F1 (ROADMAP queue 3): JAX's fused kernel drops the z -> beta_e Stokes
rotations where the fluid velocity is zero.  The port repairs it, so on a
v = 0 frame its mean Q/U after one scattering must match JAX's
``transport_rounds`` (not its fused kernel) within 4 sigma of the Monte
Carlo error.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.config import Config, Dims, Geometry, SimType, Spectrum
from mcrat_tpu.grid import build_rectilinear_index, frame_from_numpy
from mcrat_tpu.models.analytic import apply_simulation_type, cylindrical_prep, make_grid_2d
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.ops import fused_round as fr

torch.set_num_threads(1)

CFG = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
             simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float32")
EDGES = (np.linspace(0.0, 3.2e11, 33), np.linspace(1.8e12, 2.9e12, 65))
TCFG = convert.config_from_reference(CFG)


def _port(host, photons):
    return (convert.photons_from_numpy({k: np.asarray(v) for k, v in vars(photons).items()}, device="cpu"),
            convert.frame_from_numpy_fields(CFG, vars(host)).to_device("cpu"),
            convert.index_from_edges(*EDGES, device="cpu"))


def _stats(ph, n_scatt):
    d = ph if isinstance(ph, dict) else {k: np.asarray(v) for k, v in vars(ph).items()}
    alive = (d["weight"] > 0) & (d["ptype"] != 5)
    s = d["s"][alive]
    return dict(w=float(d["weight"].sum()), e=d["p"][alive, 0].mean(),
                ns=d["num_scatt"][alive].mean(),
                r=np.linalg.norm(d["pos"], axis=1)[alive].mean(),
                q=float(s[:, 1].mean()), u=float(s[:, 2].mean()), n_scatt=int(n_scatt))


@pytest.mark.parametrize("hot", [False, True], ids=["cold", "hot"])
def test_transport_frame_matches_xla(hot):
    host = frame_from_numpy(CFG, make_grid_2d(CFG, *EDGES))
    apply_simulation_type(host)
    if hot:
        host.temp[:] = 5e8  # Maxwell-Juttner regime
    arrays, _ = jt.inject_photons(
        host, r_inj=2e12, ph_weight=1e50, min_photons=1500, max_photons=4000,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 30, fps=5.0,
        rng=np.random.default_rng(11 if hot else 7))
    # one capacity for both cases: JAX compiles its frame loop once
    photons, _ = jt.photons_from_arrays(arrays, capacity=4096, dtype=jnp.float32)
    idx = build_rectilinear_index(*EDGES, dtype="float32")
    res_x = jt.transport_frame(CFG, photons, host.to_device(dtype=jnp.float32), idx,
                               jnp.float32(0.05), make_key(1), fused=False)
    tph, tframe, tidx = _port(host, photons)
    launches = fr.fused_rounds.launches
    res_t = tt.transport_frame(TCFG, tph, tframe, tidx, 0.05, torch.Generator().manual_seed(1),
                               fused=True, chunk_rounds=8, s_rows=8)
    assert fr.fused_rounds.launches == launches  # CPU: the twin, never the kernel
    assert res_t.n_rounds > 8  # several chunks, with compaction between them
    alive = res_t.photons.alive
    assert (res_t.t_rem[alive] <= 0).all()
    assert torch.equal(res_t.photons.weight, tph.weight)
    a = _stats(res_x.photons, res_x.n_scatt)
    b = _stats(convert.photons_to_numpy(res_t.photons), res_t.n_scatt)
    assert b["w"] == pytest.approx(a["w"], rel=1e-6)
    assert b["n_scatt"] == pytest.approx(a["n_scatt"], rel=0.12)
    assert b["ns"] == pytest.approx(a["ns"], rel=0.1)
    assert b["e"] == pytest.approx(a["e"], rel=0.15 if hot else 0.08)
    assert b["r"] == pytest.approx(a["r"], rel=1e-3)
    if not hot:
        assert abs(b["q"] - a["q"]) < 0.05
        assert abs(b["u"] - a["u"]) < 0.05
    stats = tt.frame_stats(res_t.photons).numpy()
    assert stats[0] == res_t.photons.num_scatt[alive].max().item()
    assert stats[2] == pytest.approx(b["ns"], rel=1e-6)
    assert stats[9] == alive.sum().item()
    assert tt.average_photon_energy(res_t.photons).item() > 0


def test_f1_zero_velocity_polarization_matches_xla():
    """v = 0 frame, an unpolarized beam tilted 0.3 rad off the jet axis, one
    scattering each: mean Q/U match transport_rounds within 4 sigma."""
    host = frame_from_numpy(CFG, make_grid_2d(CFG, *EDGES))
    cylindrical_prep(host, gamma_infinity=1.0)  # T' = 1e5 K, v = 0
    assert not host.v0.any() and not host.v1.any()
    n = 4096
    rs = np.random.default_rng(5)
    e = np.full(n, 5e-5)
    d = np.array([np.sin(0.3), 0.0, np.cos(0.3)])
    p = np.concatenate([e[:, None], e[:, None] * d[None]], axis=1)
    phi, rad = rs.random(n) * 2 * np.pi, rs.uniform(0.5e11, 2.5e11, n)
    pos = np.stack([rad * np.cos(phi), rad * np.sin(phi), rs.uniform(2.0e12, 2.6e12, n)], 1)
    s = np.zeros((n, 4))
    s[:, 0] = 1.0
    arrays = dict(p=p, comv_p=p.copy(), pos=pos, s=s, weight=np.ones(n),
                  num_scatt=np.zeros(n), cell=np.full(n, -1, np.int32),
                  ptype=np.zeros(n, np.int32))
    photons, _ = jt.photons_from_arrays(arrays, capacity=None, dtype=jnp.float32)
    t_rem = jt.frame_time(photons, jnp.float32(1e-2))
    res_x = jt.transport_rounds(CFG, photons, host.to_device(dtype=jnp.float32),
                                build_rectilinear_index(*EDGES, dtype="float32"), t_rem,
                                make_key(3), max_rounds=1)
    tph, tframe, tidx = _port(host, photons)
    res_t = tt.transport_rounds_fused(TCFG, tph, tframe, tidx, torch.from_numpy(np.array(t_rem)),
                                      base_seed=77, setup=tt.select_variant(TCFG, tframe, tidx),
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
    # the beam's scattered polarization is strong, so a basis error shows:
    # the unrepaired chain scrambles Q toward 0
    assert qa.mean() > 20 * np.sqrt(qa.var() / len(qa))
