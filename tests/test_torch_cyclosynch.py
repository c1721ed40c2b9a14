"""The port's cyclo-synchrotron module against mcrat_tpu's, on the CPU.

The frame is tests/test_cyclosynch.py's: the 2-D spherical grid of
``synthetic_spherical_frame`` (64 x 16 cells, r 1e12-1e13 cm) with the
cylindrical outflow, TOTAL_E equipartition field, eps_B = 0.5.

* The numerical functions (host numpy float64) within rtol 1e-12.
* Pool emission and replacement array for array from the same
  ``default_rng`` state: counts, cells and types exact, floats within rtol
  1e-12, the generators left in the same state.
* Absorption (float32 torch against JAX float64): masks and counts exact,
  weights within rtol 1e-6.
* ``rebin_comptonized`` within rtol 1e-12; ``rebin_population`` merges what
  JAX's merges.
* ``grow_photons``, ``append_photons_device`` and ``extract_cs_subset`` lane
  for lane against JAX's float32, the overflow of the extraction buffer too.
* ``transport_frame(cs_limit=)``: the trigger fires, the frame time is kept,
  and the frame goes on from it (``t_rem0``).
* Fault F10: the JAX package's order (rebin -> append -> absorb) absorbs the
  whole merged weight; the port places the merged photons and keeps it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.config import BFieldCalc, Config, Dims, Geometry, PhotonType, SimType
from mcrat_tpu.constants import H_OVER_MEC2
from mcrat_tpu.models.analytic import synthetic_spherical_frame
from mcrat_tpu.ops import cyclosynch as jcs
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.ops import cyclosynch as tcs

torch.set_num_threads(1)

CFG = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
             simulation_type=SimType.CYLINDRICAL_OUTFLOW, cyclosynchrotron=True,
             b_field_calc=BFieldCalc.TOTAL_E, epsilon_b=0.5, dtype="float64")
TCFG = convert.config_from_reference(dataclasses.replace(CFG, dtype="float32"))
FIELDS = ("p", "comv_p", "pos", "s", "weight", "num_scatt", "cell", "ptype")


@pytest.fixture(scope="module")
def frames():
    jhost, edges = synthetic_spherical_frame(CFG, r_min=1e12, r_max=1e13, nr=64, ntheta=16,
                                             theta_max=np.pi / 4)
    thost = convert.frame_from_numpy_fields(TCFG, vars(jhost))
    return jhost, thost, edges


def _assert_arrays(got, want, rtol=1e-12):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the numerical functions

_rs = np.random.default_rng(11)
NU_C = 10.0 ** _rs.uniform(6, 14, 64)
NU = NU_C * 10.0 ** _rs.uniform(-1, 3, 64)
THETA = 10.0 ** _rs.uniform(-4, 1, 64)  # both sides of the 0.08 switch
GAMMA = 1.0 + 10.0 ** _rs.uniform(-3, 2, 64)
DENS = 10.0 ** _rs.uniform(5, 20, 64)
TEMP = 10.0 ** _rs.uniform(4, 9.5, 64)
P_EL = 10.0 ** _rs.uniform(-2, 1, 64)
B = 10.0 ** _rs.uniform(-2, 8, 64)
NUMERICAL = dict(
    cyclotron_freq=lambda m: m.cyclotron_freq(B),
    n_el_mj=lambda m: m.n_el_mj(DENS, THETA, GAMMA),
    n_el_mb=lambda m: m.n_el_mb(DENS, THETA, GAMMA),
    _Z=lambda m: m._Z(NU, NU_C, GAMMA),
    _Z_sec_der=lambda m: m._Z_sec_der(NU, NU_C, GAMMA),
    _chi=lambda m: m._chi(THETA, GAMMA),
    _gamma0=lambda m: m._gamma0(NU, NU_C, THETA),
    jnu=lambda m: m.jnu(NU, NU_C, THETA, DENS),
    syn_cross_section=lambda m: m.syn_cross_section(
        CFG if m is jcs else TCFG, DENS, TEMP, NU, P_EL),
    cs_r_limits=lambda m: np.array(m.cs_r_limits(12, 10, 5.0, 8e12)),
    _bb_photon_count_to_nuc=lambda m: m._bb_photon_count_to_nuc(TEMP, NU_C),
)


@pytest.mark.parametrize("name", sorted(NUMERICAL))
def test_numerical_functions_match_jax(name):
    want = np.asarray(NUMERICAL[name](jcs))
    got = np.asarray(NUMERICAL[name](tcs))
    assert want.size and np.isfinite(want).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# emission


@pytest.mark.parametrize("scatt_frame,seed", [(11, 0), (13, 5)])
def test_emit_pool_photons_matches_jax(frames, scatt_frame, seed):
    jhost, thost, _ = frames
    args = (scatt_frame, 10, 5.0, 2e12, 1e50, 10000, 0.0, np.pi / 6)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want, w_want = jcs.emit_pool_photons(CFG, jhost, *args, rj)
    got, w_got = tcs.emit_pool_photons(TCFG, thost, *args, rt)
    assert len(want["weight"]) >= 1 and w_got == w_want
    _assert_arrays(got, want)
    assert (got["ptype"] == int(PhotonType.CS_POOL)).all()
    assert rt.bit_generator.state == rj.bit_generator.state


def test_emit_pool_replacements_matches_jax(frames):
    jhost, thost, _ = frames
    args = (12, 10, 5.0, 2e12, 3e47, 257, 0.0, np.pi / 6)
    rj, rt = np.random.default_rng(4), np.random.default_rng(4)
    want = jcs.emit_pool_replacements(CFG, jhost, *args, rj)
    got = tcs.emit_pool_replacements(TCFG, thost, *args, rt)
    assert len(got["weight"]) == 257
    _assert_arrays(got, want)
    assert rt.bit_generator.state == rj.bit_generator.state
    assert tcs.emit_pool_replacements(TCFG, thost, *args[:5], 0, *args[6:], rt) == {}


# ---------------------------------------------------------------------------
# absorption


def _absorption_arrays(nu_c):
    n = 32
    e_high = 5.0 * nu_c * H_OVER_MEC2
    e_low = 0.5 * nu_c * H_OVER_MEC2
    arrays = dict(
        p=np.tile([e_high, e_high, 0, 0], (n, 1)),
        comv_p=np.tile([e_high, e_high, 0, 0], (n, 1)),
        pos=np.tile([2e12, 0, 2e12], (n, 1)),
        s=np.tile([1.0, 0, 0, 0], (n, 1)),
        weight=np.linspace(1.0, 2.0, n),
        num_scatt=np.zeros(n),
        cell=np.zeros(n, np.int32),
        ptype=np.full(n, int(PhotonType.INJECTED), np.int32),
    )
    arrays["comv_p"][: n // 2, 0] = e_low
    arrays["p"][: n // 2, 0] = e_low
    arrays["ptype"][n - 2:] = int(PhotonType.CS_POOL)
    arrays["ptype"][4:8] = int(PhotonType.UNABSORBED_CS)
    arrays["ptype"][20:24] = int(PhotonType.COMPTONIZED)
    arrays["cell"][8:10] = -1  # outside the grid: never absorbed
    return arrays


def test_apply_absorption_matches_jax(frames):
    jhost, thost, _ = frames
    nu_c = float(np.asarray(jcs.cyclotron_freq(jcs.b_magnitude(CFG, jhost, np.array([0]))))[0])
    arrays = _absorption_arrays(nu_c)
    jph, _ = jt.photons_from_arrays(arrays, capacity=32, dtype=jnp.float64, weight_norm=1.0)
    jout, jn, jw = jcs.apply_absorption(CFG, jhost.to_device(dtype=jnp.float64), jph)
    jmask = np.asarray(jcs.absorption_mask(CFG, jhost.to_device(dtype=jnp.float64), jph)[0])
    tph, _ = tt.photons_from_arrays(arrays, capacity=32, device="cpu", weight_norm=1.0)
    nu_c = tcs.cell_nu_c(TCFG, thost, "cpu")
    tmask, _ = tcs.absorption_mask(tph, nu_c)
    tout, tn, tw = tcs.apply_absorption(tph, nu_c)
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    assert int(tn) == int(jn) == 16 - 2 + 2
    np.testing.assert_allclose(float(tw), float(jw), rtol=1e-6)
    np.testing.assert_array_equal(tout.ptype.numpy(), np.asarray(jout.ptype))
    np.testing.assert_allclose(tout.weight.numpy(), np.asarray(jout.weight), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tout.p[:, 0].numpy() == -1.0, np.asarray(jout.p[:, 0]) == -1.0)
    # the input population is left as it was
    assert torch.equal(tph.weight, tt.photons_from_arrays(arrays, capacity=32, device="cpu",
                                                          weight_norm=1.0)[0].weight)


def test_cell_nu_c_matches_jax(frames):
    """The per-cell nu_c the driver uploads once a frame: JAX's float64
    values within rtol 1e-12 (float32 to its rounding), finite on a frame
    hot enough that a float32 equipartition field overflows."""
    jhost, thost, _ = frames
    want = np.asarray(jcs.cyclotron_freq(jcs.b_magnitude(CFG, jhost)))
    got = tcs.cell_nu_c(TCFG, thost, "cpu", torch.float64)
    assert got.shape == (thost.num_elements,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(tcs.cell_nu_c(TCFG, thost, "cpu").numpy(), want, rtol=1e-6)
    hot = dataclasses.replace(thost, temp=np.full_like(thost.temp, 1e10))
    assert bool(torch.isfinite(tcs.cell_nu_c(TCFG, hot, "cpu")).all())
    t32 = torch.tensor(1e10, dtype=torch.float32)
    assert not bool(torch.isfinite(tcs.calc_b(TCFG, torch.ones(()), t32)))


# ---------------------------------------------------------------------------
# rebinning


def _cs_population(n, seed, dims=3):
    rng = np.random.default_rng(seed)
    e = rng.lognormal(-18, 0.3, n)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(
        p=np.concatenate([e[:, None], e[:, None] * d], axis=1),
        comv_p=np.zeros((n, 4)),
        pos=np.abs(rng.normal(size=(n, 3))) * 1e12 + 1e12,
        s=np.tile([1.0, 0.05, 0.0, 0.0], (n, 1)),
        weight=rng.uniform(0.5, 2.0, n),
        num_scatt=rng.integers(1, 40, n).astype(float),
        cell=np.zeros(n, np.int32),
        ptype=np.full(n, int(PhotonType.COMPTONIZED), np.int32),
    )


@pytest.mark.parametrize("dims", [Dims.TWO, Dims.THREE])
def test_rebin_comptonized_matches_jax(dims):
    ph = _cs_population(5000, 7)
    extra = {"t_rem": np.random.default_rng(8).uniform(0.0, 0.2, 5000)}
    cfg = dataclasses.replace(CFG, dims=dims)
    want = jcs.rebin_comptonized(cfg, ph, 2000, extra=extra)
    got = tcs.rebin_comptonized(convert.config_from_reference(cfg), ph, 2000, extra=extra)
    assert len(got["weight"]) < 5000
    _assert_arrays(got, want)
    np.testing.assert_allclose(got["weight"].sum(), ph["weight"].sum(), rtol=1e-12)


def _both(arrays, cap, t=None):
    """The same float32 population in either package (and t_rem)."""
    jph, _ = jt.photons_from_arrays(arrays, capacity=cap, dtype=jnp.float32, weight_norm=1.0)
    tph, _ = tt.photons_from_arrays(arrays, capacity=cap, device="cpu", weight_norm=1.0)
    if t is None:
        return jph, tph
    tz = np.zeros(cap, np.float32)
    tz[:len(t)] = t
    return jph, tph, jnp.asarray(tz), torch.from_numpy(tz)


def _assert_lanes(tph, jph):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tph, k).numpy(), np.asarray(getattr(jph, k)),
                                      err_msg=k)


def test_rebin_population_matches_jax():
    arrays = _cs_population(3000, 3)
    arrays["ptype"][::5] = int(PhotonType.INJECTED)
    arrays["ptype"][1::7] = int(PhotonType.UNABSORBED_CS)
    t = np.random.default_rng(9).uniform(0.0, 0.2, 3000)
    jph, tph, jt_, tt_ = _both(arrays, 4096, t)
    n_cs = int(tt._count_cs(tph))
    assert n_cs == int(jt._count_cs(jph)) > 500
    jnul, jm, jmt = jcs.rebin_population(CFG, jph, None, 500, n_cs=n_cs, t_rem=jt_)
    tnul, tm, tmt = tcs.rebin_population(TCFG, tph, 500, n_cs=n_cs, t_rem=tt_)
    _assert_arrays(tm, jm)
    np.testing.assert_allclose(tmt, jmt, rtol=1e-12, atol=0)
    _assert_lanes(tnul, jnul)
    assert tcs.rebin_population(TCFG, tph, n_cs, n_cs=n_cs) == (tph, None, None)


# ---------------------------------------------------------------------------
# population surgery, lane for lane


def _mixed(n, seed):
    arrays = _cs_population(n, seed)
    arrays["cell"] = np.arange(n, dtype=np.int32)
    arrays["ptype"] = np.random.default_rng(seed).integers(0, 6, n).astype(np.int32)
    arrays["weight"][::3] = 0.0  # dead lanes to fill
    return arrays


def test_grow_and_append_match_jax():
    base, new = _mixed(200, 1), _cs_population(60, 2)
    t = np.random.default_rng(3).uniform(0.0, 1.0, 200)
    jph, tph, jtr, ttr = _both(base, 256, t)
    jg, jgt = jt.grow_photons(jph, 512, t_rem=jtr)
    tg, tgt = tt.grow_photons(tph, 512, t_rem=ttr)
    _assert_lanes(tg, jg)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jgt))
    assert tt.grow_photons(tph, 512)[1] is None
    jnew, tnew, jnt, tnt = _both(new, 64, np.full(60, 0.5))
    jout, jot = jt.append_photons_device(jg, jnew, t_rem=jgt, new_t=jnt)
    tout, tot = tt.append_photons_device(tg, tnew, tgt, tnt)
    _assert_lanes(tout, jout)
    np.testing.assert_array_equal(tot.numpy(), np.asarray(jot))
    # the free slots first, ascending; the given population untouched
    assert int(tout.alive.sum()) == int(tg.alive.sum()) + 60
    assert torch.equal(tg.weight, tt.grow_photons(tph, 512)[0].weight)
    # more new lanes than free slots: the rest are dropped, as JAX's
    full = dict(base, weight=np.ones(200))
    jf, tf = _both(full, 210)
    _assert_lanes(tt.append_photons_device(tf, tnew)[0], jt.append_photons_device(jf, jnew))


@pytest.mark.parametrize("n_out", [16, 64])
def test_extract_cs_subset_matches_jax(n_out):
    """48 CS lanes of 64: with a 16-lane buffer the overflow lanes stay
    live CS photons for the next trigger (tests/test_cyclosynch.py's
    round-4 finding)."""
    n = 64
    e = np.full(n, 1e-6)
    arrays = dict(
        p=np.stack([e, e, np.zeros(n), np.zeros(n)], axis=-1),
        comv_p=np.stack([e, e, np.zeros(n), np.zeros(n)], axis=-1),
        pos=np.tile([1e12, 0.0, 2.7e12], (n, 1)), s=np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
        weight=np.arange(1.0, n + 1), num_scatt=np.ones(n), cell=np.zeros(n, np.int32),
        ptype=np.full(n, int(PhotonType.COMPTONIZED), np.int32))
    arrays["ptype"][::4] = int(PhotonType.INJECTED)
    arrays["ptype"][1::8] = int(PhotonType.UNABSORBED_CS)
    t = np.linspace(0.0, 1.0, n)
    jph, tph, jtr, ttr = _both(arrays, n, t)
    jnul, jsub, jst = jt.extract_cs_subset(jph, n_out, t_rem=jtr)
    tnul, tsub, tst = tt.extract_cs_subset(tph, n_out, t_rem=ttr)
    _assert_lanes(tnul, jnul)
    _assert_lanes(tsub, jsub)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_allclose(float(tnul.weight.sum() + tsub.weight.sum()),
                               float(tph.weight.sum()), rtol=1e-7)
    assert int(tt._count_cs(tnul)) == max(48 - n_out, 0)
    assert not tt.extract_cs_subset(tph, n_out)[2].any()


# ---------------------------------------------------------------------------
# the mid-frame trigger


def test_transport_frame_cs_limit_exits_and_resumes(frames):
    """tests/test_cyclosynch.py's trigger test on the twin: COMPTONIZED
    photons at 1e-6 m_e c^2 in the frame; with cs_limit=100 the frame exits
    at a chunk boundary with rebin_pending, the CS count and each photon's
    frame time; rebin_population merges the CS lanes (weight conserved) and
    the frame goes on from t_rem0 to its end."""
    _, thost, edges = frames
    frame = thost.to_device("cpu")
    index = convert.index_from_edges(*edges, device="cpu")
    rng = np.random.default_rng(3)
    n = 4096
    e = np.full(n, 1e-6)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    arrays = dict(
        p=np.concatenate([e[:, None], e[:, None] * d], axis=1),
        comv_p=np.concatenate([e[:, None], e[:, None] * d], axis=1),
        pos=np.stack([np.full(n, 1e12), np.zeros(n), np.full(n, 2.7e12)], axis=-1),
        s=np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)), weight=np.ones(n), num_scatt=np.zeros(n),
        cell=np.full(n, -1, np.int32), ptype=np.full(n, int(PhotonType.COMPTONIZED), np.int32))
    ph, meta = tt.photons_from_arrays(arrays, capacity=n, device="cpu")
    gen = torch.Generator().manual_seed(0)
    res = tt.transport_frame(TCFG, ph, frame, index, 0.2, gen, chunk_rounds=4, fused=True,
                             cs_limit=100)
    assert res.rebin_pending and res.n_cs == n > 100 and res.n_rounds == 4
    assert float(res.t_rem.max()) > 0.0 and float(res.t_rem.max()) < 0.2
    ph2, merged, merged_t = tcs.rebin_population(TCFG, res.photons, 100, n_cs=res.n_cs,
                                                 t_rem=res.t_rem)
    assert 0 < len(merged["weight"]) <= res.n_cs and (merged_t > 0).all()
    np.testing.assert_allclose(float(ph2.weight.double().sum()) + merged["weight"].sum(),
                               float(res.photons.weight.double().sum()), rtol=1e-10)
    assert int(tt._count_cs(ph2)) == 0
    # re-entry: the merged photons appended with their frame time, to the end
    new, _ = tt.photons_from_arrays(merged, capacity=tt._pow2(len(merged["weight"])),
                                    device="cpu", weight_norm=meta.weight_norm)
    new = tcs.place_in_cells(TCFG, frame, index, new)
    t_new = torch.zeros(new.capacity)
    t_new[:len(merged_t)] = torch.as_tensor(merged_t, dtype=torch.float32)
    ph3, t3 = tt.append_photons_device(ph2, new, res.t_rem, t_new)
    res2 = tt.transport_frame(TCFG, ph3, frame, index, 0.2, gen, chunk_rounds=0, fused=True,
                              t_rem0=t3, cs_limit=10 ** 6)
    assert not res2.rebin_pending and res2.n_cs == len(merged["weight"])
    assert float(res2.t_rem[res2.photons.alive].max()) <= 0.0
    assert res2.n_scatt > 0
    # without the trigger armed the frame runs to its end
    res3 = tt.transport_frame(TCFG, ph, frame, index, 0.2, torch.Generator().manual_seed(0),
                              chunk_rounds=4, fused=True)
    assert not res3.rebin_pending and res3.n_cs is None


# ---------------------------------------------------------------------------
# fault F10


def test_f10_merged_photons_survive_absorption(frames):
    """5,000 COMPTONIZED photons far above nu_c in the frame, merged into a
    few hundred.  The JAX package's order (rebin_comptonized -> append ->
    apply_absorption) absorbs every merged photon: their comv_p is 0 and
    their cell 0.  The port places them (cell from the index, comv_p the
    boosted lab momentum): the merged weight survives, as the unmerged
    photons' does."""
    jhost, thost, edges = frames
    rng = np.random.default_rng(1)
    n = 5000
    cells = rng.integers(0, jhost.num_elements, n)
    phi = rng.uniform(0.0, 2 * np.pi, n)
    r, th = jhost.r[cells], jhost.theta[cells]
    pos = np.stack([r * np.sin(th) * np.cos(phi), r * np.sin(th) * np.sin(phi),
                    r * np.cos(th)], axis=-1)
    nu_c = np.asarray(jcs.cyclotron_freq(jcs.b_magnitude(CFG, jhost))).max()
    e = 1e3 * nu_c * H_OVER_MEC2 * rng.uniform(1.0, 2.0, n)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p = np.concatenate([e[:, None], e[:, None] * d], axis=1)
    arrays = dict(p=p, comv_p=p.copy(), pos=pos, s=np.tile([1.0, 0, 0, 0], (n, 1)),
                  weight=np.ones(n), num_scatt=np.ones(n), cell=cells.astype(np.int32),
                  ptype=np.full(n, int(PhotonType.COMPTONIZED), np.int32))
    jframe = jhost.to_device(dtype=jnp.float64)
    jph, _ = jt.photons_from_arrays(arrays, capacity=n, dtype=jnp.float64, weight_norm=1.0)
    assert int(jcs.apply_absorption(CFG, jframe, jph)[1]) == 0  # unmerged: none absorbed

    merged = jcs.rebin_comptonized(CFG, arrays, max_photons=2000)
    m = len(merged["weight"])
    assert 50 < m < n
    jm, _ = jt.photons_from_arrays(merged, capacity=m, dtype=jnp.float64, weight_norm=1.0)
    _, jn, _ = jcs.apply_absorption(CFG, jframe, jm)
    assert int(jn) == m  # F10: the JAX order loses the whole merged weight

    tmerged = tcs.rebin_comptonized(TCFG, arrays, max_photons=2000)
    frame = thost.to_device("cpu")
    nu_c_cell = tcs.cell_nu_c(TCFG, thost, "cpu")
    index = convert.index_from_edges(*edges, device="cpu")
    tm, _ = tt.photons_from_arrays(tmerged, capacity=m, device="cpu", weight_norm=1.0)
    placed = tcs.place_in_cells(TCFG, frame, index, tm)
    in_grid = placed.cell >= 0
    assert int(in_grid.sum()) > 0.9 * m
    nu_comv = placed.comv_p[:, 0].double() / H_OVER_MEC2
    assert bool((nu_comv[in_grid] > nu_c_cell[placed.cell[in_grid].long()].double()).all())
    out, tn, _ = tcs.apply_absorption(placed, nu_c_cell)
    assert int(tn) == 0
    np.testing.assert_allclose(float(out.weight.double().sum()), n, rtol=1e-6)
    # the comoving momentum is the fused round's boost: the twin's first
    # round recomputes the same value on an in-grid lane
    cell, _ = tt.find_cell_direct(TCFG, index, frame, placed.pos)
    assert torch.equal(cell, placed.cell)
