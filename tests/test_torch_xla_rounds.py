"""The port's XLA engine against the JAX package's, given the same threefry
key, on the CPU at a small size.

Frames (tests/test_torch_geometry_cases.py and test_torch_amr_cases.py, thin
enough that photons scatter and cross cells within a few rounds):

* ``cyl2``: 2-D cylindrical (packed_cyl2, a phi-hat velocity), DIRECT,
  Stokes on, a tenth of the photons CS pool photons (they scatter in place
  and are promoted);
* ``sph2``: 2-D spherical (ultra_sph2's grid), DIRECT, Stokes off;
* ``cart3``: 3-D cartesian on a non-uniform axis, TABLE at T' = 5e8 K;
* ``amr``: the AMR cell list behind a ``BinnedIndex``, TABLE with bench.py's
  power-law electrons (the biased population choice);
* ``cyl2_f32``: ``cyl2`` in float32.

Checks, per frame: ``grid.find_cell_rows`` (every lane searched, or the
misses only) cell for cell (displaced photons,
cached cells and misses), ``_tau_rate`` element by element (rtol 1e-12),
and ``transport_rounds`` lane for lane.  In float64: identical scatter
counts, photon types and cells, and every continuous field within rtol 1e-9
of its vector's scale.  Stokes Q, U are held per lane to 1e-12 plus what
the rotations that lane went through may add (``RotationErrors``): a basis
rotation's sin 2theta = 2 d sqrt(1 - d^2) turns an error delta of a few
ulp in 1 - d^2 into min(delta / sqrt(1 - d^2), sqrt(delta)), ~1e-8 only
where |d| ~ 1 (the fluid boost almost along z-hat, the jet axis), so lanes
away from the axis are held near 1e-12.  In float32 both sides use JAX's
float32 Klein-Nishina form (monkeypatched into the port, fault F6 left in)
and the lanes agree within float32 conditioning (rtol 1e-4; Stokes 1e-2,
the same square-root amplification of float32's last place); a lane whose
rejection test sits within rounding of its boundary may take the other
branch: at most 1 in 200 lanes, each named in the failure message.

Then ``transport_frame(fused=False)``, chunked and compacted, against JAX's
on the same key (float64, lane for lane), and the port's float32 XLA engine
against its own kernel twin, in distribution (4 sigma).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import grid as jgrid
from mcrat_tpu import transport as jt
from mcrat_tpu.config import PhotonType, Spectrum
from mcrat_tpu.ops import cyclosynch as jcs
from mcrat_tpu.ops import hot_xsec as jhx
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import grid as tgrid
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.ops import compton as tcompton
from mcrat_tpu_torch.ops import fused_round as fr
from mcrat_tpu_torch.ops import prng
from mcrat_tpu_torch.ops import stokes as tstokes

import test_torch_amr_cases as ac
import test_torch_geometry_cases as gc

torch.set_num_threads(1)

KEY_SEED = 77
ROUNDS = 8


def _f64(cfg):
    return dataclasses.replace(cfg, dtype="float64")


def _inject(jhost, inj, seed, n_min=600, n_max=1500):
    arrays, _ = jt.inject_photons(jhost, ph_weight=1e50, min_photons=n_min, max_photons=n_max,
                                  spect=Spectrum.BLACKBODY, theta_min=0.0, fps=5.0,
                                  rng=np.random.default_rng(seed), **inj)
    return arrays


class Case:
    """One frame in both packages: configs, frames, indices, photons, the
    tables of a TABLE run."""

    def __init__(self, kind):
        self.kind = kind
        dtype = "float32" if kind.endswith("f32") else "float64"
        jtab = ttab = None
        if kind.startswith("cyl2"):
            cfg, host, edges, inj = gc.frame_case("packed_cyl2", thin=True)
        elif kind == "sph2":
            cfg, host, edges, inj = gc.frame_case("ultra_sph2", thin=True)
        elif kind == "cart3":
            cfg, host, edges, inj = gc.frame_case("packed_cart3", temp=5e8, thin=True)
            cfg = gc.table_cfg(cfg)
        else:
            cfg = gc.table_cfg(ac.CFG, "powerlaw")
            host, _ = ac.amr_hosts(_f64(cfg), gamma=2.0, temp=5e8, thin=1e-3)
            edges, inj = None, ac.INJ
        cfg = dataclasses.replace(cfg, dtype=dtype)
        host.cfg = cfg
        if kind != "amr" and cfg.nonthermal_e_dist.value != "off":
            host.nonthermal_dens = jcs.nonthermal_electron_dens(cfg, host)
        self.jcfg, self.jhost = cfg, host
        self.tcfg = convert.config_from_reference(cfg)
        jdt, tdt = (jnp.float64, torch.float64) if dtype == "float64" else (jnp.float32,
                                                                            torch.float32)
        self.jdt, self.tdt = jdt, tdt
        if cfg.tau_calculation.value == "table":
            jtab = jhx.load_or_build(cfg, None, dtype=dtype)
            ttab = convert.xsec_table_from_numpy(
                *(None if a is None else np.asarray(a) for a in (
                    jtab.log_e, jtab.log_t, jtab.thermal, jtab.nonthermal, jtab.subgroup_frac)))
        self.jtab, self.ttab = jtab, ttab
        self.jframe = host.to_device(dtype=jdt)
        self.tframe = convert.frame_from_numpy_fields(cfg, vars(host)).to_device("cpu", dtype=tdt)
        if edges is None:
            self.jidx = jgrid.build_binned_index(host)
            self.tidx = convert.binned_index_from_numpy(
                *(np.asarray(a) for a in (self.jidx.cell_ids, self.jidx.bin_start,
                                          self.jidx.bin_count, self.jidx.grid_min,
                                          self.jidx.inv_bin)),
                self.jidx.dims, self.jidx.max_slab, dtype=tdt, device="cpu")
        else:
            self.jidx = jgrid.build_rectilinear_index(*edges, dtype=dtype)
            self.tidx = convert.index_from_edges(*edges, dtype=tdt, device="cpu")
        arrays = _inject(host, inj, seed=5)
        if kind.startswith("cyl2"):
            arrays["ptype"][::10] = int(PhotonType.CS_POOL)
        self.arrays = arrays
        self.jph, _ = jt.photons_from_arrays(arrays, capacity=None, dtype=jdt)
        self.tph, _ = tt.photons_from_arrays(arrays, dtype=tdt, device="cpu", weight_norm=float(
            np.median(arrays["weight"])))
        self.stokes = kind != "sph2"
        self.dt = 0.3


_CASES = {}


def case(kind):
    if kind not in _CASES:
        _CASES[kind] = Case(kind)
    return _CASES[kind]


KINDS = ["cyl2", "sph2", "cart3", "amr"]


@pytest.fixture
def jax_f32_kn(monkeypatch):
    """JAX's float32 Klein-Nishina form and Fano normalization in the port's
    scatter (F6 and F13 left in)."""
    monkeypatch.setattr(tcompton, "kn_cross_section", gc.jax_f32_kn)
    monkeypatch.setattr(tstokes, "fano_normalized", gc.jax_f32_fano)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel_to_scale(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = np.abs(want).max(axis=-1, keepdims=True) if want.ndim > 1 else np.abs(want)
    return np.abs(got - want) / np.maximum(scale, np.finfo(np.float64).tiny)


@pytest.mark.parametrize("kind", KINDS)
def test_find_cell_and_tau_rate(kind):
    c = case(kind)
    rs = np.random.default_rng(3)
    pos = c.arrays["pos"] * (1.0 + rs.uniform(-0.02, 0.02, c.arrays["pos"].shape))
    cached = c.arrays["cell"].copy()
    cached[::3] = -1
    jcell, jin = jax.jit(jgrid.find_cell, static_argnums=0)(
        c.jcfg, c.jidx, c.jframe, jnp.asarray(pos, c.jdt), jnp.asarray(cached))
    for all_lanes in (True, False):
        tcell, tin = tgrid.find_cell_rows(c.tcfg, c.tidx, c.tframe,
                                          torch.as_tensor(pos, dtype=c.tdt),
                                          torch.as_tensor(cached), all_lanes=all_lanes)
        np.testing.assert_array_equal(tcell.numpy(), np.asarray(jcell))
        np.testing.assert_array_equal(tin.numpy(), np.asarray(jcell) >= 0)
    # JAX's second output: the lanes its cached cell's box still holds
    assert (np.asarray(jin) <= ((tcell.numpy() == cached) & (cached >= 0))).all()
    assert (tcell.numpy() >= 0).mean() > 0.5 and ((tcell.numpy() != cached) & (cached >= 0)).any()

    # the optical depth at the injected photons' cells
    cell = c.arrays["cell"]
    jrows = jgrid.gather_rows(c.jframe, jnp.asarray(cell))
    want = jax.jit(jt._tau_rate, static_argnums=0)(c.jcfg, c.jframe, c.jph, jnp.asarray(cell),
                                                   c.jtab, rows=jrows)
    got = tt._tau_rate(c.tcfg, c.tph, tgrid.gather_rows(c.tframe, torch.as_tensor(cell)), c.ttab)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-12, atol=1e-15)
    assert (got[2] is None) == (want[2] is None) == (kind != "amr")
    if kind == "amr":
        for g, w in zip(got[2], want[2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


# the error of 1 - d^2 in a float64 Stokes rotation: d is a ratio of dot
# products and a rsqrt, a few ulp (1.1e-16) each, and squaring doubles it
ROTATION_DELTA = 4e-15


class RotationErrors:
    """Per lane, the Stokes error float64 rounding may build up in the port's
    rotations (``ops.stokes._rotation_cs``, every basis and boost rotation
    of the chain): 1e-12, plus min(delta / sqrt(1 - d^2), sqrt(delta)) for
    each rotation the lane went through (delta = ROTATION_DELTA; f == 0 is
    the exact identity).  Lanes are followed through ``transport_frame``'s
    compaction by the slots ``_compact_step`` returns."""

    def __init__(self, monkeypatch, n):
        self.bound = torch.full((n,), 1e-12, dtype=torch.float64)
        self.slots = torch.arange(n)
        rotation, compact = tstokes._rotation_cs, tt._compact_step

        def record(d, f):
            assert d.shape == self.slots.shape, (d.shape, self.slots.shape)
            cond = torch.sqrt(torch.clamp(1.0 - d * d, min=0.0))
            err = torch.clamp(ROTATION_DELTA / cond, max=ROTATION_DELTA ** 0.5)
            keep = self.slots < n
            self.bound.index_add_(0, self.slots[keep], torch.where(f == 0, 0.0, err)[keep])
            return rotation(d, f)

        def compact_step(*a):
            out = compact(*a)
            self.slots = out[3]
            return out

        monkeypatch.setattr(tstokes, "_rotation_cs", record)
        monkeypatch.setattr(tt, "_compact_step", compact_step)


def _compare_lanes(got, want, exact=True, stokes_bound=None):
    """Photons of the port (``got``) and JAX (``want``) lane for lane;
    returns the lanes whose scatter count differs (float32).  In float64,
    ``stokes_bound`` is ``RotationErrors.bound``."""
    g = convert.photons_to_numpy(got)
    w = {k: np.asarray(v) for k, v in vars(want).items()}
    flipped = np.flatnonzero(g["num_scatt"] != w["num_scatt"])
    if exact:
        assert flipped.size == 0, flipped
    same = np.ones(len(g["weight"]), bool)
    same[flipped] = False
    np.testing.assert_array_equal(g["ptype"][same], w["ptype"][same])
    np.testing.assert_array_equal(g["weight"], w["weight"])
    rtol = 1e-9 if exact else 1e-4
    for k in ("p", "comv_p", "pos"):
        err = _rel_to_scale(g[k], w[k])[same]
        assert (err <= rtol).all(), (k, np.flatnonzero((err > rtol).any(-1))[:10], err.max())
    stokes = np.abs(g["s"] - w["s"]).max(-1)
    bound = stokes_bound.numpy() if exact else np.full(len(stokes), 1e-2)
    over = np.flatnonzero((stokes > bound) & same)
    assert over.size == 0, (over[:10], stokes[over[:10]], bound[over[:10]])
    cells = np.flatnonzero((g["cell"] != w["cell"]) & same)
    if exact:
        assert cells.size == 0, cells
    return flipped


def _port_rounds(c, key, max_rounds=ROUNDS):
    return tt.transport_rounds(c.tcfg, c.tph, c.tframe, c.tidx, tt.frame_time(c.tph, c.dt), key,
                               xsec_table=c.ttab, stokes_on=c.stokes, max_rounds=max_rounds)


def _jax_rounds(c, key, max_rounds=ROUNDS):
    return jt.transport_rounds(c.jcfg, c.jph, c.jframe, c.jidx, jt.frame_time(c.jph, c.dt), key,
                               xsec_table=c.jtab, stokes_on=c.stokes, max_rounds=max_rounds)


@pytest.mark.parametrize("kind", KINDS)
def test_transport_rounds_lane_for_lane_float64(kind, monkeypatch):
    c = case(kind)
    rotations = RotationErrors(monkeypatch, c.tph.capacity)
    got = _port_rounds(c, prng.Key.from_seed(KEY_SEED))
    want = _jax_rounds(c, make_key(KEY_SEED, impl="threefry2x32"))
    assert got.n_rounds == int(want.n_rounds) >= 3
    assert int(got.n_scatt) == int(want.n_scatt) > 20
    assert got.n_scatt.dtype == torch.int64  # as JAX's float64 count
    _compare_lanes(got.photons, want.photons, stokes_bound=rotations.bound)
    np.testing.assert_allclose(got.t_rem.numpy(), np.asarray(want.t_rem), rtol=1e-9,
                               atol=1e-9 * c.dt)
    assert bool(got.all_done) == bool(want.all_done)
    assert int(got.n_active) == int(want.n_active)
    if kind == "cyl2":
        # the scattered pool photons were promoted (and move from then on);
        # the others stayed where they were
        pool0 = c.arrays["ptype"] == int(PhotonType.CS_POOL)
        ptype = got.photons.ptype.numpy()
        moved = (got.photons.pos.numpy() != c.arrays["pos"]).any(-1)
        promoted = pool0 & (ptype == int(PhotonType.COMPTONIZED))
        assert promoted.any() and (pool0 & ~promoted).any()
        assert not moved[pool0 & ~promoted].any() and moved[~pool0].any()
    # the input population is untouched
    np.testing.assert_array_equal(c.tph.pos.numpy(), c.arrays["pos"])


def test_transport_rounds_float32_within_rounding(jax_f32_kn):
    c = case("cyl2_f32")
    got = _port_rounds(c, prng.Key.from_seed(KEY_SEED))
    want = _jax_rounds(c, make_key(KEY_SEED, impl="threefry2x32"))
    assert got.n_rounds == int(want.n_rounds) and got.n_scatt.dtype == torch.int32
    flipped = _compare_lanes(got.photons, want.photons, exact=False)
    assert flipped.size <= c.tph.capacity // 200, f"lanes that took the other branch: {flipped}"
    assert abs(int(got.n_scatt) - int(want.n_scatt)) <= max(flipped.size, 0) * ROUNDS


def test_transport_frame_chunked_and_compacted(monkeypatch):
    """transport_frame(fused=False), chunks of ROUNDS rounds (JAX reuses the
    lane test's executable) with compaction into 512 lanes, against JAX's on
    the same key: lane for lane (float64)."""
    c = case("cyl2")
    monkeypatch.setattr(tt, "MIN_COMPACT_CAPACITY", 512)
    compactions = []
    step = tt._compact_step
    monkeypatch.setattr(tt, "_compact_step", lambda *a: compactions.append(a[-1]) or step(*a))
    rotations = RotationErrors(monkeypatch, c.tph.capacity)
    res = tt.transport_frame(c.tcfg, c.tph, c.tframe, c.tidx, 2.0, None, chunk_rounds=ROUNDS,
                             fused=False, key=prng.Key.from_seed(KEY_SEED))
    assert res.engine == "xla" and compactions and set(compactions) == {512}
    want = jt.transport_frame(c.jcfg, c.jph, c.jframe, c.jidx, jnp.float64(2.0),
                              make_key(KEY_SEED, impl="threefry2x32"), chunk_rounds=ROUNDS,
                              fused=False, min_compact_capacity=512)
    assert res.n_rounds == want.n_rounds > ROUNDS and res.n_scatt == want.n_scatt
    _compare_lanes(res.photons, want.photons, stokes_bound=rotations.bound)
    alive = res.photons.alive
    assert (res.t_rem[alive] <= 0).all()
    # the caller's photons were not written
    np.testing.assert_array_equal(c.tph.pos.numpy(), c.arrays["pos"])


def test_engine_choice():
    """fused=None on CPU float32 photons takes the XLA engine (no kernel
    there); fused=True takes the kernel's twin; float64 with fused=True
    raises."""
    c = case("cyl2_f32")
    gen = torch.Generator().manual_seed(3)
    launches = fr.fused_rounds.launches
    res = tt.transport_frame(c.tcfg, c.tph, c.tframe, c.tidx, 0.01, gen, chunk_rounds=4)
    assert res.engine == "xla" and res.n_rounds > 0
    res = tt.transport_frame(c.tcfg, c.tph, c.tframe, c.tidx, 0.01, gen, chunk_rounds=4,
                             fused=True, s_rows=8)
    assert res.engine == "kernel" and fr.fused_rounds.launches == launches
    c64 = case("cyl2")
    with pytest.raises(ValueError, match="float32 photons only"):
        tt.transport_frame(c64.tcfg, c64.tph, c64.tframe, c64.tidx, 0.01, gen, fused=True)
    with pytest.raises(ValueError, match="generator="):
        tt.transport_frame(c.tcfg, c.tph, c.tframe, c.tidx, 0.01, None, fused=True)


def test_float32_xla_engine_matches_the_kernel_twin():
    """The port's two engines on one float32 frame (the flagship's Gamma =
    100 outflow on its 32 x 64 cut): lab energy, scatterings and Stokes Q
    within 4 sigma; the same photons finish."""
    cfg, host, edges, inj = gc.frame_case("ultra_cyl2", gamma=100.0)
    tcfg = convert.config_from_reference(cfg)
    arrays = _inject(host, inj, seed=9, n_min=2500, n_max=4000)
    tframe = convert.frame_from_numpy_fields(cfg, vars(host)).to_device("cpu")
    tidx = convert.index_from_edges(*edges, device="cpu")
    out = {}
    for fused in (True, False):
        tph, _ = tt.photons_from_arrays(arrays, device="cpu")
        res = tt.transport_frame(tcfg, tph, tframe, tidx, 0.05, torch.Generator().manual_seed(1),
                                 chunk_rounds=8, fused=fused, s_rows=8,
                                 key=prng.Key.from_seed(2))
        assert res.engine == ("kernel" if fused else "xla")
        out[fused] = ac.stats(convert.photons_to_numpy(res.photons), res.n_scatt)
    assert out[True]["n"] == out[False]["n"] and out[False]["ns"] > 0.5
    ac.assert_within_4_sigma(out[True], out[False])
