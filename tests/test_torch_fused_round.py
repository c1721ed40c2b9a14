"""The fused-round twin and glue of the port against the JAX kernel.

``fused_rounds_reference`` draws the interpret-mode stream of
``mcrat_tpu/ops/pallas_round.py::_Rng`` with the same static draw numbers,
so it is held against ``pallas_round.fused_rounds(..., interpret=True)``
lane for lane: the scatter count and the out-flags of >= 99.9 % of lanes
must be identical, and idle-block lanes bit-identical.

Fault F6 is repaired in the port's Klein-Nishina cross section (float64
closed form, ``test_torch_f6``); on the hot frame, whose electron-frame
energies reach the band where JAX's float32 form is off by up to 0.25, the
lane-for-lane test puts JAX's float32 form in the port's place
(``monkeypatch``), so that both accept the same scatterings.

Continuous state is compared with tolerances set by float32 conditioning.
XLA-CPU contracts products into FMAs and approximates sqrt/rsqrt, so the two
differ by ulps, and the algorithm amplifies ulps in two places:
  * 1 - beta cos and the photon boosts cancel to ~1/(2 Gamma^2), so at the
    flagship's Gamma = 100 one ulp becomes ~1e-3 relative in momenta and
    free paths.  The kernel-level cases therefore run on a Gamma = 2 frame,
    where every non-Stokes plane agrees to rtol 1e-4 / atol 1e-6;
  * Stokes rotation angles come from cosines (sqrt(1 - d^2)), worth
    ~sqrt(eps) = 3e-4 per rotation, and a polarized phi rejection near its
    edge can flip -- so |dq|, |du|, |dv| <= 5e-3 on >= 99.5 % of lanes (a
    float64 evaluation of the twin puts JAX's own float32 kernel up to 0.1
    off on single lanes, the twin within 1e-3).
The glue-level test runs the Gamma = 100 flagship-type frame and holds the
discrete state lane for lane, positions per lane, and the rest in aggregate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.config import (
    Config, Dims, Geometry, NonthermalDist, PhotonType, SimType, Spectrum, TauCalculation,
)
from mcrat_tpu.grid import build_rectilinear_index, find_cell_direct, frame_from_numpy
from mcrat_tpu.models.analytic import cylindrical_prep, make_grid_2d
from mcrat_tpu.ops import pallas_round as pr
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.config import Config as TConfig
from mcrat_tpu_torch.config import Dims as TDims
from mcrat_tpu_torch.config import Geometry as TGeometry
from mcrat_tpu_torch.config import NonthermalDist as TNonthermal
from mcrat_tpu_torch.config import TauCalculation as TTau
from mcrat_tpu_torch.ops import fused_round as fr
from mcrat_tpu_torch.ops import rng as trng

from test_torch_geometry_cases import jax_f32_fano, jax_f32_kn

torch.set_num_threads(1)

S_ROWS = 8
BLOCK = S_ROWS * pr.LANES
NON_STOKES = [i for i in range(fr.N_STATE) if i not in (fr.SP_Q, fr.SP_U, fr.SP_V)]
STOKES = [fr.SP_Q, fr.SP_U, fr.SP_V]


def test_state_layout_matches_jax():
    for name in ("SP_P0", "SP_X", "SP_Q", "SP_TREM", "SP_NS", "SP_C0", "N_STATE",
                 "FLAG_ALIVE", "FLAG_POOL", "FLAG_INGRID", "OUT_STALLED", "OUT_PROMOTED",
                 "LANES"):
        assert getattr(fr, name) == getattr(pr, name), name
    assert fr.THETA_MB_SWITCH == pr._THETA_MB_SWITCH and fr.TINY == pr._TINY


@pytest.mark.parametrize("seed,pid", [(0, 0), (123456789, 1), (-987654321, 5), (2**31 - 1, 63)])
def test_counter_rng_matches_interpret_stream(seed, pid):
    rng = pr._Rng((S_ROWS, pr.LANES), interpret=True)
    rng.seed(jnp.int32(seed), jnp.int32(pid))
    lanes = torch.arange(BLOCK) + pid * BLOCK
    base = trng.lane_base(seed, lanes, BLOCK)
    for k in range(1, 9):
        want = np.asarray(rng.uniform_pos() if k % 3 == 0 else rng.uniform()).reshape(-1)
        got = (trng.uniform_pos if k % 3 == 0 else trng.uniform)(base, k)
        np.testing.assert_array_equal(got.numpy(), want)


def _cylinder(gamma, hot, seed, n_min, n_max):
    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype="float32")
    r0e = np.linspace(0.0, 3.2e11, 33)
    r1e = np.linspace(1.8e12, 2.9e12, 65)
    host = frame_from_numpy(cfg, make_grid_2d(cfg, r0e, r1e))
    cylindrical_prep(host, gamma_infinity=gamma)
    if hot:
        host.temp[:] = 5e8
    idx = build_rectilinear_index(r0e, r1e, dtype="float32")
    arrays, _ = jt.inject_photons(
        host, r_inj=2e12, ph_weight=1e50, min_photons=n_min, max_photons=n_max,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 30, fps=5.0,
        rng=np.random.default_rng(seed))
    photons, _ = jt.photons_from_arrays(arrays, capacity=None, dtype=jnp.float32)
    return cfg, host, idx, (r0e, r1e), photons


def _kernel_inputs(gamma, hot):
    """Planes of 3 logical blocks (block 1 idle) from an injected population."""
    cfg, host, idx, edges, photons = _cylinder(gamma, hot, 11 if hot else 7, 1000, 2 * BLOCK)
    frame = host.to_device(dtype=jnp.float32)
    n_pad, cap = 3 * BLOCK, photons.capacity
    assert cap <= 2 * BLOCK
    # photons fill blocks 0 and 2; block 1 holds a copy of the first lanes
    # and is marked idle
    order = np.concatenate([np.arange(BLOCK), np.arange(BLOCK), np.arange(BLOCK, 2 * BLOCK)])

    def plane(x):
        a = np.zeros(2 * BLOCK, np.float32)
        a[:cap] = np.asarray(x, np.float32)
        return a[order]

    p, pos, s, c = (np.asarray(a) for a in (photons.p, photons.pos, photons.s, photons.comv_p))
    state = np.stack(
        [plane(p[:, i]) for i in range(4)] + [plane(pos[:, i]) for i in range(3)]
        + [plane(s[:, i]) for i in (1, 2, 3)]
        + [plane(np.full(cap, 0.05)), plane(np.zeros(cap))]
        + [plane(c[:, i]) for i in range(4)])
    alive = plane(np.asarray(photons.alive)) > 0
    # every 7th live lane is a CS pool photon: scatters in place, never moves
    pool = alive & (np.arange(alive.size) % 7 == 3)
    cell, in_grid = find_cell_direct(cfg, idx, frame, jnp.asarray(state[fr.SP_X:fr.SP_Z + 1].T))
    safe = np.clip(np.asarray(cell), 0, frame.num_elements - 1).astype(np.int32)
    flags = (alive.astype(np.int32) * fr.FLAG_ALIVE + pool.astype(np.int32) * fr.FLAG_POOL
             + np.asarray(in_grid).astype(np.int32) * fr.FLAG_INGRID)
    n1 = len(edges[1]) - 1
    dom = np.asarray(frame.domain, np.float32).reshape(-1)
    lo0, lo1 = np.float32(edges[0][0]), np.float32(edges[1][0])
    e0, e1 = (np.asarray(e, np.float32) for e in edges)
    d0, d1 = np.float32(e0[1] - e0[0]), np.float32(e1[1] - e1[0])
    geom = np.concatenate([dom, np.array([lo0, d0, lo1, d1], np.float32)])
    grid = fr.GridScalars(*(float(x) for x in dom[:4]), float(lo0), float(d0), float(lo1),
                          float(d1), n1)
    phys = np.array(np.asarray(frame.packed_slim)[4:8])
    return cfg, state, alive, pool, safe, flags, n1, phys, geom, grid


@pytest.mark.parametrize("hot,stokes_on", [(False, True), (False, False), (True, True)],
                         ids=["cold-stokes", "cold-nostokes", "hot-stokes"])
def test_twin_matches_jax_kernel_lane_for_lane(hot, stokes_on, monkeypatch):
    monkeypatch.setattr(fr, "_kn_cross_section", jax_f32_kn)
    monkeypatch.setattr(fr, "_fano_normalized", jax_f32_fano)
    cfg, state, alive, pool, safe, flags, n1, phys, geom, grid = _kernel_inputs(2.0, hot)
    block_act = np.array([1, 0, 1], np.int32)
    seed = 987654321
    ci = safe // n1
    flags_j = flags | (ci << 17) | ((safe - ci * n1) << 3)
    res = pr.fused_rounds(
        cfg, jnp.int32(seed), jnp.asarray(geom), jnp.asarray(state.reshape(16, -1, pr.LANES)),
        jnp.asarray(phys[:, safe].reshape(4, -1, pr.LANES)),
        jnp.asarray(flags_j.reshape(1, -1, pr.LANES)), block_act=jnp.asarray(block_act),
        stokes_on=stokes_on, inner_rounds=2, s_rows=S_ROWS, interpret=True, ultra=True)
    js = np.asarray(res.state).reshape(16, -1)
    jf = np.asarray(res.out_flags).reshape(-1)

    ts = torch.from_numpy(state.copy())
    calls = (fr.fused_rounds.launches, fr.fused_rounds_reference.launches)
    tf = fr.fused_rounds(ts, torch.from_numpy(safe), torch.from_numpy(flags),
                         torch.from_numpy(phys), torch.from_numpy(block_act), seed, grid,
                         stokes_on=stokes_on, inner_rounds=2, block_lanes=BLOCK).numpy()
    # a CPU tensor runs the plain twin, never the kernel
    assert (fr.fused_rounds.launches, fr.fused_rounds_reference.launches) == (
        calls[0], calls[1] + 1)
    ts = ts.numpy()

    on = np.repeat(block_act != 0, BLOCK)
    live = on & alive
    for out_state, out_flags in ((ts, tf), (js, jf)):
        np.testing.assert_array_equal(out_state[:, ~on], state[:, ~on])
        assert not out_flags[~on].any()
    assert (js[fr.SP_NS] - state[fr.SP_NS]).sum() > 500  # photons do scatter
    same = (ts[fr.SP_NS] == js[fr.SP_NS]) & (tf == jf) & live
    assert same.sum() >= 0.999 * live.sum(), (live.sum() - same.sum(), live.sum())
    for i in NON_STOKES:
        np.testing.assert_allclose(ts[i][same], js[i][same], rtol=1e-4, atol=1e-6,
                                   err_msg=f"plane {i}")
    d = np.max([np.abs(ts[i][same] - js[i][same]) for i in STOKES], axis=0)
    assert (d <= 5e-3).mean() >= 0.995, np.quantile(d, [0.5, 0.99, 1.0])
    if not stokes_on:
        np.testing.assert_array_equal(ts[STOKES], state[STOKES])
    # pool lanes stay put and are promoted when they scatter
    np.testing.assert_array_equal(ts[fr.SP_X:fr.SP_Z + 1][:, pool & on],
                                  state[fr.SP_X:fr.SP_Z + 1][:, pool & on])
    promoted = (tf & fr.OUT_PROMOTED) != 0
    assert promoted[pool & on].any() and not promoted[~pool].any()


def test_glue_matches_jax_fused_transport_flagship_frame():
    """Port transport_rounds_fused (twin) against JAX's, Gamma = 100 frame."""
    cfg, host, idx, edges, photons = _cylinder(100.0, False, 7, 1500, 4000)
    # every 5th photon is a CS pool photon (promoted to COMPTONIZED on scatter)
    ptype = np.asarray(photons.ptype).copy()
    ptype[::5] = int(PhotonType.CS_POOL)
    photons = photons.replace(ptype=jnp.asarray(ptype))
    frame = host.to_device(dtype=jnp.float32)
    t_rem = jt.frame_time(photons, jnp.float32(0.05))
    key = make_key(1)
    res = jt.transport_rounds_fused(cfg, photons, frame, idx, t_rem, key, max_rounds=8,
                                    inner_rounds=2, s_rows=S_ROWS, interpret=True)
    base_seed = int(jax.random.randint(key, (), jnp.iinfo(jnp.int32).min,
                                       jnp.iinfo(jnp.int32).max, dtype=jnp.int32))
    tframe = convert.frame_from_numpy_fields(cfg, vars(host)).to_device("cpu")
    tidx = convert.index_from_edges(*edges, device="cpu")
    tcfg = convert.config_from_reference(cfg)
    tres = tt.transport_rounds_fused(
        tcfg, convert.photons_from_numpy({k: np.asarray(v) for k, v in vars(photons).items()}, device="cpu"),
        tframe, tidx, torch.from_numpy(np.array(t_rem)), base_seed=base_seed,
        setup=tt.select_variant(tcfg, tframe, tidx), max_rounds=8, inner_rounds=2, s_rows=S_ROWS)
    a = {k: np.asarray(v) for k, v in vars(res.photons).items()}
    b = convert.photons_to_numpy(tres.photons)
    assert tres.n_rounds == int(res.n_rounds) == 8
    n = len(a["weight"])
    same = a["num_scatt"] == b["num_scatt"]
    assert same.sum() >= 0.999 * n
    assert (a["cell"] == b["cell"]).sum() >= 0.999 * n
    np.testing.assert_array_equal(a["cell"][same], b["cell"][same])
    for k in ("ptype", "weight"):
        np.testing.assert_array_equal(a[k], b[k])
    assert (b["ptype"] == int(PhotonType.COMPTONIZED)).any()  # pool promotion ran
    assert int(tres.n_scatt) == pytest.approx(int(res.n_scatt), rel=1e-3)
    dpos = np.linalg.norm(a["pos"] - b["pos"], axis=1)
    assert (dpos[same] <= 1e-4 * np.linalg.norm(a["pos"], axis=1)[same]).all()
    for k, col in (("p", 0), ("comv_p", 0)):
        assert b[k][same, col].mean() == pytest.approx(a[k][same, col].mean(), rel=1e-3)
    for col in (1, 2):
        assert abs(b["s"][:, col].mean() - a["s"][:, col].mean()) < 0.01
    np.testing.assert_array_equal(tres.t_rem.numpy() > 0, np.asarray(res.t_rem) > 0)


def test_fused_rounds_wrapper_checks_inputs():
    state = torch.zeros((fr.N_STATE, BLOCK))
    ints = torch.zeros(BLOCK, dtype=torch.int32)
    phys = torch.zeros((4, 8))
    grid = fr.GridScalars(0.0, 1.0, 0.0, 1.0, 0.0, 0.125, 0.0, 0.125, 8)
    act = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="meta"):
        fr.fused_rounds(state.to("meta"), ints.to("meta"), ints.to("meta"),
                        phys.to("meta"), act.to("meta"), 0, grid, block_lanes=BLOCK)
    with pytest.raises(ValueError, match="multiple"):
        fr.fused_rounds(state[:, :100].contiguous(), ints[:100], ints[:100], phys, act, 0,
                        grid, block_lanes=BLOCK)
    with pytest.raises(ValueError, match="phys"):
        fr.fused_rounds(state, ints, ints, phys.double(), act, 0, grid, block_lanes=BLOCK)
    out = fr.fused_rounds(state, ints, ints, phys, act, 0, grid, block_lanes=BLOCK)
    assert out.dtype == torch.int32 and not out.any()


def test_unported_configurations_raise():
    jcfg, host, idx, edges, photons = _cylinder(100.0, False, 7, 1500, 4000)
    cfg = convert.config_from_reference(jcfg)
    ph = convert.photons_from_numpy({k: np.asarray(v) for k, v in vars(photons).items()}, device="cpu")
    frame = convert.frame_from_numpy_fields(cfg, vars(host)).to_device("cpu")
    index = convert.index_from_edges(*edges, device="cpu")
    # on CPU the kernel is not available: the default takes the XLA engine
    # (ROADMAP item 5, ported), fused=True the twin; no run switches engines
    assert not tt.fused_transport_available(cfg, ph, frame, index)
    assert tt.transport_frame(cfg, ph, frame, index, 0.05, torch.Generator()).engine == "xla"
    # TABLE and nonthermal electrons are ported, but TABLE without its tables
    # raises: no quiet sigma_hat = 1
    table = TConfig(dims=TDims.TWO, geometry=TGeometry.CYLINDRICAL,
                    tau_calculation=TTau.TABLE)
    nonthermal = TConfig(dims=TDims.TWO, geometry=TGeometry.CYLINDRICAL,
                         tau_calculation=TTau.TABLE,
                         nonthermal_e_dist=TNonthermal.POWERLAW, powerlaw_index=2.5,
                         gamma_min=1.0, gamma_max=100.0)
    for c in (table, nonthermal):
        assert tt.unsupported_reason(c, frame, index) is None
        assert not tt.fused_transport_available(c, ph, frame, index)
        with pytest.raises(ValueError, match="xsec_table"):
            tt.transport_frame(c, ph, frame, index, 0.05, torch.Generator(), fused=True)
        with pytest.raises(ValueError, match="xsec_table"):
            tt.select_variant(c, frame, index)
    thermal_only = convert.xsec_table_from_numpy(np.zeros(2), np.zeros(2), np.zeros((2, 2)))
    with pytest.raises(ValueError, match="subgroup"):
        tt.select_variant(nonthermal, frame, index, thermal_only)
    # geometry variants are ported: non-uniform grids and spherical frames run
    nonuniform = convert.index_from_edges(edges[0], np.geomspace(1.8e12, 2.9e12, 65),
                                         device="cpu")
    assert tt.unsupported_reason(cfg, frame, nonuniform) is None
    assert tt.select_variant(cfg, frame, nonuniform).variant == "slim_cyl2"
    sph = TConfig(dims=TDims.TWO, geometry=TGeometry.SPHERICAL)
    assert tt.unsupported_reason(sph, frame, index) is None
    # cyclo-synchrotron is ported (test_torch_cyclosynch*), float64 runs on
    # the XLA engine (test_torch_xla_rounds); an object that is no index (the
    # AMR BinnedIndex is ported, test_torch_amr_*) raises, and the kernel
    # refuses float64 photons: it has no float64 form
    assert tt.unsupported_reason(TConfig(
        dims=TDims.TWO, geometry=TGeometry.CYLINDRICAL, cyclosynchrotron=True), frame, index) is None
    assert "not a spatial index" in tt.unsupported_reason(cfg, frame, object())
    with pytest.raises(NotImplementedError, match="not a spatial index"):
        tt.select_variant(cfg, frame, object())
    ph64 = convert.photons_from_numpy({k: np.asarray(v) for k, v in vars(photons).items()},
                                      dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="float32 photons only"):
        tt.transport_rounds_fused(cfg, ph64, frame, index, tt.frame_time(ph64, 0.05),
                                  base_seed=0, setup=tt.select_variant(cfg, frame, index))
    assert tt.unsupported_reason(cfg, frame, index) is None


@pytest.mark.parametrize("mode", ["direct", "table", "nonthermal"])
def test_draw_layout_matches_interpret_stream(mode, monkeypatch):
    """The draws one JAX kernel round traces (``_Rng._calls``) are the
    port's ``per_round``: 115 for DIRECT and TABLE, 117 with nonthermal
    electrons (the population draw and the sampler's uniform)."""
    made = []

    class Recording(pr._Rng):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(pr, "_Rng", Recording)
    kw = {}
    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL, dtype="float32")
    rows = 16
    if mode != "direct":
        kw["cheb_base"] = 16
        rows = 32
    if mode == "nonthermal":
        cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL, dtype="float32",
                     tau_calculation=TauCalculation.TABLE,
                     nonthermal_e_dist=NonthermalDist.POWERLAW, powerlaw_index=2.5,
                     gamma_min=1.0, gamma_max=100.0)
        kw.update(nonthermal=True, nt_sub1=tuple(float(i) for i in range(18)))
    # a shape no other test compiles, so the kernel body is traced here
    pr.fused_rounds(cfg, jnp.int32(1), jnp.zeros(6, jnp.float32),
                    jnp.zeros((16, 3, pr.LANES), jnp.float32),
                    jnp.ones((rows, 3, pr.LANES), jnp.float32),
                    jnp.zeros((1, 3, pr.LANES), jnp.int32), inner_rounds=3, s_rows=3,
                    interpret=True, **kw)
    assert made
    want = fr.OFFSETS_NT if mode == "nonthermal" else fr.OFFSETS
    assert made[-1]._calls == 3 * want.per_round
    assert want.per_round == fr.OFFSETS.per_round + (2 if mode == "nonthermal" else 0)
