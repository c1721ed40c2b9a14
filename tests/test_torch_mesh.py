"""The port's mesh (``mcrat_tpu_torch.parallel``) on the CPU, against the JAX
package's on the conftest's virtual CPU devices.

* The float64 XLA-engine sharded frame on 2 and 4 shards, chunked and
  compacted, lane for lane against JAX's ``sharded_transport_frame`` with
  the same threefry key (tests/test_torch_xla_rounds.py's ``cyl2`` frame, a
  4,096-lane population): counts, flags and cells exact, continuous fields
  within rtol 1e-9 of the vector's scale, Stokes per lane within what the
  lane's rotations may add (``ShardRotations``, that file's bound followed
  through each shard and through the mesh's compaction).
* The fused twin's sharded chunk: each shard bit for bit
  ``transport_rounds_fused`` on its slab with its seed (the i-th of the
  chunk's draws); a one-shard mesh bit for bit ``transport_frame``, chunked
  and compacted.
* tests/test_parallel.py's four checks on the port: an 8-shard float64
  frame, the 8-shard fused frame (chunked, compacted) against the XLA
  engine on one device, a sharded driver run killed, restarted and merged
  across angles, and a sharded driver pass.
* The mesh's own pieces: slabs and replicas, appends, growth, the
  scattered-CS extraction and the live gather against their one-device
  counterparts; ``dryrun_multichip`` on the CPU; a mesh of more cards than
  torch sees raises; the cyclo-synchrotron driver on a one-shard mesh bit
  for bit the one-device run, and a forced-rebin run on two shards.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu import transport as jt
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu.parallel import make_mesh as jmake_mesh
from mcrat_tpu.parallel import shard_photons as jshard
from mcrat_tpu.parallel import sharded_transport_frame as jsharded
from mcrat_tpu.parallel.mesh import replicate as jreplicate
from mcrat_tpu_torch import Config, Dims, Geometry, McPar, SimType, Spectrum
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import driver as tdriver
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.grid import build_rectilinear_index
from mcrat_tpu_torch.io import hydro as thydro
from mcrat_tpu_torch.io import photons_h5 as tph
from mcrat_tpu_torch.io.checkpoint import CheckpointState, load_checkpoint, save_checkpoint
from mcrat_tpu_torch.models.analytic import synthetic_spherical_frame
from mcrat_tpu_torch.ops import prng
from mcrat_tpu_torch.ops import stokes as tstokes
from mcrat_tpu_torch.parallel import mesh as pm
from mcrat_tpu_torch.parallel.dryrun import dryrun_multichip

import test_torch_amr_cases as ac
from test_torch_xla_rounds import KEY_SEED, ROTATION_DELTA, ROUNDS, _compare_lanes, case

torch.set_num_threads(1)

CAP = 4096  # lanes of the lane-for-lane population: compaction fires at < 1024


class ShardRotations:
    """tests/test_torch_xla_rounds.py's ``RotationErrors`` on a mesh: each
    shard's ``transport_rounds`` call (in shard order, every chunk) maps
    its slab's lanes to the working set's global lanes, and the mesh's
    compaction (``parallel.mesh._compact_sharded``) to population slots."""

    def __init__(self, monkeypatch, n_lanes, n_shards):
        self.bound = torch.full((n_lanes,), 1e-12, dtype=torch.float64)
        self.slots = torch.arange(n_lanes)
        self.lanes = None
        self.calls = 0
        rotation, rounds, compact = tstokes._rotation_cs, tt.transport_rounds, pm._compact_sharded

        def record(d, f):
            assert d.shape == self.lanes.shape, (d.shape, self.lanes.shape)
            cond = torch.sqrt(torch.clamp(1.0 - d * d, min=0.0))
            err = torch.clamp(ROTATION_DELTA / cond, max=ROTATION_DELTA ** 0.5)
            keep = self.lanes < n_lanes
            self.bound.index_add_(0, self.lanes[keep], torch.where(f == 0, 0.0, err)[keep])
            return rotation(d, f)

        def shard_rounds(cfg, photons, *a, **k):
            shard, slab = self.calls % n_shards, photons.capacity
            self.calls += 1
            self.lanes = self.slots[shard * slab:(shard + 1) * slab]
            return rounds(cfg, photons, *a, **k)

        def compact_step(*a):
            out = compact(*a)
            self.slots = pm.fetch_global(out[3])
            return out

        monkeypatch.setattr(tstokes, "_rotation_cs", record)
        monkeypatch.setattr(tt, "transport_rounds", shard_rounds)
        monkeypatch.setattr(pm, "_compact_sharded", compact_step)


def _populations(c):
    jph, _ = jt.photons_from_arrays(c.arrays, capacity=CAP, dtype=jnp.float64)
    tph_, _ = tt.photons_from_arrays(c.arrays, capacity=CAP, dtype=torch.float64, device="cpu",
                                     weight_norm=float(np.median(c.arrays["weight"])))
    return jph, tph_


@pytest.mark.parametrize("n", [2, 4])
def test_float64_sharded_frame_lane_for_lane(n, monkeypatch):
    c = case("cyl2")
    jph, tph_ = _populations(c)
    compactions = []
    step = pm._compact_sharded
    monkeypatch.setattr(pm, "_compact_sharded", lambda *a: compactions.append(a[-1]) or step(*a))
    rotations = ShardRotations(monkeypatch, CAP, n)
    mesh = pm.make_mesh(devices=["cpu"] * n)
    res = pm.sharded_transport_frame(c.tcfg, mesh, tph_, c.tframe, c.tidx, 2.0,
                                     chunk_rounds=ROUNDS, fused=False,
                                     key=prng.Key.from_seed(KEY_SEED))
    jmesh = jmake_mesh(devices=jax.devices()[:n])
    want = jsharded(c.jcfg, jmesh, jshard(jph, jmesh), jreplicate(c.jframe, jmesh),
                    jreplicate(c.jidx, jmesh), jnp.float64(2.0),
                    make_key(KEY_SEED, impl="threefry2x32"), chunk_rounds=ROUNDS, fused=False)
    assert res.engine == "xla" and compactions == [1024]
    assert res.n_rounds == want.n_rounds > ROUNDS and res.n_scatt == want.n_scatt > 100
    got = pm.fetch_global(res.photons)
    _compare_lanes(got, want.photons, stokes_bound=rotations.bound)
    np.testing.assert_allclose(pm.fetch_global(res.t_rem).numpy(), np.asarray(want.t_rem),
                               rtol=1e-9, atol=1e-12)
    # the caller's population was not written
    np.testing.assert_array_equal(tph_.pos[:len(c.arrays["pos"])].numpy(), c.arrays["pos"])


def _spherical(dtype="float32", n_min=2000, n_max=6000, seed=5):
    """tests/test_parallel.py's frame: the 2-D spherical outflow on 96 x 16
    cells, photons injected at 4e12 cm."""
    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 simulation_type=SimType.SPHERICAL_OUTFLOW, dtype=dtype)
    tdt = torch.float64 if dtype == "float64" else torch.float32
    host, (r_edges, t_edges) = synthetic_spherical_frame(
        cfg, r_min=1e12, r_max=2e13, nr=96, ntheta=16, theta_max=np.pi / 3)
    idx = build_rectilinear_index(r_edges, t_edges, dtype=tdt, device="cpu")
    arrays, _ = tt.inject_photons(
        host, r_inj=4e12, ph_weight=1e50, min_photons=n_min, max_photons=n_max,
        spect=Spectrum.BLACKBODY, theta_min=0.0, theta_max=np.pi / 6, fps=5.0,
        rng=np.random.default_rng(seed))
    return cfg, host.to_device("cpu", dtype=tdt), idx, arrays, tdt


def test_fused_shards_are_single_device_calls():
    """Each shard of a one-chunk sharded frame equals transport_rounds_fused
    on its slab with the chunk's i-th seed, bit for bit."""
    cfg, frame, idx, arrays, _ = _spherical()
    n = 4
    ph, _ = tt.photons_from_arrays(arrays, capacity=pm.pad_capacity(len(arrays["weight"]), n,
                                                                     1.3), device="cpu")
    mesh = pm.make_mesh(devices=["cpu"] * n)
    res = pm.sharded_transport_frame(cfg, mesh, ph, frame, idx, 0.4,
                                     torch.Generator().manual_seed(7), chunk_rounds=0,
                                     fused=True, s_rows=8)
    gen = torch.Generator().manual_seed(7)
    seeds = [tt.draw_seed(gen) for _ in range(n)]
    slabs = pm.shard_photons(ph, mesh)
    setup = tt.select_variant(cfg, frame, idx)
    n_scatt = 0
    for i, slab in enumerate(slabs.parts):
        want = tt.transport_rounds_fused(cfg, slab, frame, idx, tt.frame_time(slab, 0.4),
                                         seeds[i], setup=setup, s_rows=8)
        got = res.photons.parts[i]
        for k in got.fields():
            assert torch.equal(getattr(got, k), getattr(want.photons, k)), (i, k)
        assert torch.equal(res.t_rem.parts[i], want.t_rem)
        n_scatt += int(want.n_scatt)
    assert res.n_scatt == n_scatt > 0 and res.engine == "kernel"


def test_one_shard_mesh_is_transport_frame():
    """A one-shard mesh draws what transport_frame draws: the chunked,
    compacted frame bit for bit."""
    cfg, frame, idx, arrays, _ = _spherical()
    ph, _ = tt.photons_from_arrays(arrays, capacity=pm.pad_capacity(len(arrays["weight"]), 1,
                                                                     1.3), device="cpu")
    want = tt.transport_frame(cfg, ph, frame, idx, 0.4, torch.Generator().manual_seed(3),
                              chunk_rounds=6, fused=True, s_rows=8)
    compactions = []
    step = pm._compact_sharded
    pm_mesh = pm.make_mesh(devices=["cpu"])
    try:
        pm._compact_sharded = lambda *a: compactions.append(a[-1]) or step(*a)
        res = pm.sharded_transport_frame(cfg, pm_mesh, ph, frame, idx, 0.4,
                                         torch.Generator().manual_seed(3), chunk_rounds=6,
                                         fused=True, s_rows=8)
    finally:
        pm._compact_sharded = step
    assert compactions and (res.n_scatt, res.n_rounds) == (want.n_scatt, want.n_rounds)
    got = pm.fetch_global(res.photons)
    for k in got.fields():
        assert torch.equal(getattr(got, k), getattr(want.photons, k)), k
    assert torch.equal(pm.fetch_global(res.t_rem), want.t_rem)


# ---------------------------------------------------------------------------
# tests/test_parallel.py's checks on the port
# ---------------------------------------------------------------------------


def test_sharded_transport_matches_expectations():
    cfg, frame, idx, arrays, tdt = _spherical("float64", 400, 2000, seed=11)
    mesh = pm.make_mesh(devices=["cpu"] * 8)
    cap = pm.pad_capacity(len(arrays["weight"]), 8, factor=1.25)
    ph, _ = tt.photons_from_arrays(arrays, capacity=cap, dtype=tdt, device="cpu")
    res = pm.sharded_transport_frame(cfg, mesh, pm.shard_photons(ph, mesh), frame, idx, 0.2,
                                     key=prng.Key.from_seed(0))
    out = pm.fetch_global(res.photons)
    # population conserved, scattering happened, the result stays in 8 slabs
    np.testing.assert_allclose(float(out.weight.sum()), float(ph.weight.sum()), rtol=1e-12)
    assert res.n_scatt > 0 and res.engine == "xla"
    assert len(res.photons.parts) == 8 and res.photons.slab == cap // 8
    alive = out.alive.numpy()
    d = np.linalg.norm(out.pos.numpy() - ph.pos.numpy(), axis=1)
    assert (d[alive] > 0).all()


def test_sharded_fused_chunked_compaction():
    """The mesh's main path: the fused twin on 8 shards, bounded-round
    chunks and compaction, against the XLA engine on one device."""
    cfg, frame, idx, arrays, tdt = _spherical()
    mesh = pm.make_mesh(devices=["cpu"] * 8)
    cap = pm.pad_capacity(len(arrays["weight"]), 8, factor=1.3)
    ph, _ = tt.photons_from_arrays(arrays, capacity=cap, device="cpu")
    compactions = []
    step = pm._compact_sharded
    try:
        pm._compact_sharded = lambda *a: compactions.append(a[-1]) or step(*a)
        res = pm.sharded_transport_frame(cfg, mesh, ph, frame, idx, 0.4,
                                         torch.Generator().manual_seed(3), chunk_rounds=6,
                                         fused=True, s_rows=8)
    finally:
        pm._compact_sharded = step
    assert res.n_rounds > 6 and compactions and res.engine == "kernel"
    out = pm.fetch_global(res.photons)
    np.testing.assert_allclose(float(out.weight.sum()), float(ph.weight.sum()), rtol=1e-6)
    res_x = tt.transport_frame(cfg, ph, frame, idx, 0.4, chunk_rounds=0, fused=False,
                               key=prng.Key.from_seed(4))
    assert res.n_scatt == pytest.approx(res_x.n_scatt, rel=0.15)
    for o in (out, res_x.photons):
        assert o.alive.sum() == ph.alive.sum()
    e_f, e_x = (o.p[o.alive, 0].double().mean().item() for o in (out, res_x.photons))
    assert e_f == pytest.approx(e_x, rel=0.1)
    r_f, r_x = (o.pos[o.alive].double().norm(dim=1).mean().item() for o in (out, res_x.photons))
    assert r_f == pytest.approx(r_x, rel=0.01)


PAR = McPar(fps=5.0, last_frame=12, r0_domain=(1e12, 5e13), r1_domain=(0.0, 1.0),
            r2_domain=(0.0, 0.0), theta_min_deg=0.0, theta_max_deg=6.0, n_theta_bins=1,
            frm0=(10,), frm2=(10,), inj_radius=(8e12,), spect=Spectrum.BLACKBODY,
            min_photons=300, max_photons=1500, restart="i")
CFG64 = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
               simulation_type=SimType.SPHERICAL_OUTFLOW, dtype="float64")


def _mesh_run(tmp_path, par, mesh, cfg=CFG64, **kw):
    paths = thydro.HydroPaths(filepath=str(tmp_path) + "/", mc_path="MC/")
    factory = tdriver.default_synthetic_factory(cfg, par, nr=96, ntheta=16)
    return tdriver.run_rank(cfg, par, paths, synthetic_frame_factory=factory, device="cpu",
                            output="npz", mesh=mesh, **kw)


def test_mesh_kill_restart_merge_end_to_end(tmp_path):
    """A sharded run killed mid-run (a crafted checkpoint at scatt frame 12
    of injection 11) restarts with restart='c' and merges across angle
    directories (tests/test_parallel.py's resilience loop)."""
    par = dataclasses.replace(PAR, last_frame=13, frm2=(11,), min_photons=2000,
                              max_photons=8000)
    mesh = pm.make_mesh(devices=["cpu"] * 8)
    work = _mesh_run(tmp_path, par, mesh, chunk_rounds=8)
    host, _ = tdriver.default_synthetic_factory(CFG64, par, nr=96, ntheta=16)(10)
    arrays, _ = tt.inject_photons(host, work.r_inj, 1e50, par.min_photons, par.max_photons,
                                  par.spect, work.theta_min, work.theta_max, par.fps,
                                  np.random.default_rng(17))
    ph, meta = tt.photons_from_arrays(arrays, dtype=torch.float64, device="cpu")
    save_checkpoint(work.mc_dir, 0, CheckpointState(
        frame=11, frm2=11, scatt_frame=12, time_now=12 / par.fps, restart="c",
        weight_norm=meta.weight_norm, n_injected=meta.n_injected),
        convert.photons_to_numpy(ph))
    work2 = _mesh_run(tmp_path, dataclasses.replace(par, restart="c"), mesh, chunk_rounds=8)
    assert work2.mc_dir == work.mc_dir
    assert tph.discover_frames(tph.list_proc_files(work.mc_dir)) == [10, 11, 12, 13]
    counts = tph.merge_across_angles(os.path.dirname(work.mc_dir))
    assert set(counts) == {10, 11, 12, 13} and all(v > 0 for v in counts.values())
    # the resumed injection's photons, in 8 slabs of its injection capacity
    state, loaded = load_checkpoint(work.mc_dir, 0, dtype=torch.float64, device="cpu")
    assert state.restart == "i" and loaded is None


def test_driver_with_mesh(tmp_path):
    """A full driver pass with the photon axis over 8 shards."""
    mesh = pm.make_mesh(devices=["cpu"] * 8)
    work = _mesh_run(tmp_path, PAR, mesh)
    assert tph.discover_frames(tph.list_proc_files(work.mc_dir)) == [10, 11, 12]


# ---------------------------------------------------------------------------
# The mesh's pieces against their one-device counterparts
# ---------------------------------------------------------------------------


def _numpy(ph):
    return {k: v.numpy() for k, v in ph.fields().items()}


def test_population_operations_match_one_device():
    """append, grow, the scattered-CS extraction, the live gather and the
    statistics on a 4-shard mesh against the one-device functions on the
    same global population (holes in the slabs, CS photons in each)."""
    _, _, _, arrays, _ = _spherical(n_min=600, n_max=900, seed=2)
    n = len(arrays["weight"])
    arrays["ptype"][::3] = int(tt.PhotonType.COMPTONIZED)
    ph, _ = tt.photons_from_arrays(arrays, capacity=1024, device="cpu")
    ph.weight[::5] = 0.0  # free slots inside every slab
    mesh = pm.make_mesh(devices=["cpu"] * 4)
    sp = pm.shard_photons(ph, mesh)
    assert [p.capacity for p in sp.parts] == [256] * 4
    assert all(torch.equal(a, b) for a, b in zip(pm.fetch_global(sp).fields().values(),
                                                 ph.fields().values()))
    with pytest.raises(ValueError, match="not divisible"):
        pm.shard_photons(tt.grow_photons(ph, 1026)[0], mesh)
    # statistics
    want = tt.frame_stats(ph).tolist()
    got = pm.frame_stats(sp)
    exact = [0, 1, 4, 5, 6, 7, 8, 9, 10]
    assert [got[i] for i in exact] == [want[i] for i in exact]
    np.testing.assert_allclose([got[2], got[3]], [want[2], want[3]], rtol=1e-6)
    # append 300 photons (more than the first slabs' free slots)
    new, _ = tt.photons_from_arrays({k: v[:300] for k, v in arrays.items()}, capacity=512,
                                    device="cpu")
    t = torch.rand(1024, generator=torch.Generator().manual_seed(1))
    nt = torch.rand(512, generator=torch.Generator().manual_seed(2))
    want_ph, want_t = tt.append_photons_device(ph, new, t, nt)
    got_sp, got_t = pm.append_photons(sp, new, pm.shard_photons(t, mesh), nt)
    for k, v in pm.fetch_global(got_sp).fields().items():
        assert torch.equal(v, getattr(want_ph, k)), k
    assert torch.equal(pm.fetch_global(got_t), want_t)
    # growth keeps every photon in its shard
    grown, grown_t = pm.grow(sp, 2048, pm.shard_photons(t, mesh))
    assert [p.capacity for p in grown.parts] == [512] * 4
    for p, q, tq in zip(sp.parts, grown.parts, grown_t.parts):
        assert torch.equal(q.p[:256], p.p) and not q.alive[256:].any() and not tq[256:].any()
    # the first 100 scattered-CS lanes, nulled and gathered in lane order
    want_pop, want_sub, want_st = tt.extract_cs_subset(ph, 100, t)
    got_pop, got_sub, got_st = pm.extract_cs_subset(sp, 100, pm.shard_photons(t, mesh))
    for k, v in pm.fetch_global(got_pop).fields().items():
        assert torch.equal(v, getattr(want_pop, k)), k
    for k, v in got_sub.fields().items():
        assert torch.equal(v, getattr(want_sub, k)[:got_sub.capacity]), k
    assert got_sub.capacity == 100 and torch.equal(got_st, want_st)
    # the persistence subset: the live lanes in order, then dead pads
    want_live = tt.compact_live(ph, 1024)
    got_live = pm.gather_live(sp, 1024)
    n_live = int(ph.alive.sum())
    for k, v in got_live.fields().items():
        assert torch.equal(v[:n_live], getattr(want_live, k)[:n_live]), k
    assert not got_live.alive[n_live:].any() and got_live.capacity == 1024
    # replicas: one copy a distinct device
    reps = pm.replicate(ph, mesh)
    assert len(reps) == 4 and all(r.p is ph.p for r in reps)
    assert n > 600


def test_dryrun_multichip_on_cpu():
    out = dryrun_multichip(2, "cpu")
    assert out["small_blocks"]["engine"] == out["main_shape"]["engine"] == "kernel"
    assert out["n_photons"] >= 16384


def test_mesh_of_more_cards_than_there_are_raises():
    with pytest.raises((ValueError, RuntimeError)):
        pm.local_devices(torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ValueError, match="one shard"):
        pm.local_devices(2, "cpu")
    assert pm.local_devices(1, "cpu") == [torch.device("cpu")]


def test_cyclosynchrotron_driver_on_a_mesh(tmp_path, caplog):
    """tests/test_torch_cyclosynch_driver.py's run (pool emission, promotion,
    replacement, absorption) on a one-shard mesh writes the one-device
    run's dumps bit for bit; then chip_smoke's toy forced-rebin run
    (frame 10's photons marked scattered-CS at a resume, max_photons 200)
    on a two-shard mesh fires both rebins and drops no photon weight to a
    pool photon in the dumps."""
    import logging

    from mcrat_tpu_torch.io import checkpoint as tck
    from test_torch_cyclosynch_driver import GRID, TCFG, _tpar

    def run(path, par, mesh, **kw):
        paths = thydro.HydroPaths(filepath=str(path) + "/", mc_path="MC/")
        factory = tdriver.default_synthetic_factory(TCFG, par, **GRID)
        kw = {"chunk_rounds": 0, "device": "cpu", "output": "npz", "mesh": mesh, **kw}
        return tdriver.run_rank(TCFG, par, paths, synthetic_frame_factory=factory, **kw)

    def dumps(work):
        return {f: tph.read_frame(os.path.join(work.mc_dir, "mc_proc_0", str(f), b))
                for f in tph.discover_frames(tph.list_proc_files(work.mc_dir))
                for b in os.listdir(os.path.join(work.mc_dir, "mc_proc_0", str(f)))}

    par = _tpar(n_theta_bins=1, frm0=(10,), frm2=(10,), inj_radius=(8e12,))
    plain = dumps(run(tmp_path / "plain", par, None))
    one = dumps(run(tmp_path / "one", par, pm.make_mesh(devices=["cpu"])))
    assert sorted(plain) == sorted(one) == [10, 11, 12, 13]
    for f in plain:
        assert all(np.array_equal(plain[f][k], one[f][k]) for k in plain[f]), f

    mesh = pm.make_mesh(devices=["cpu"] * 2)
    cfg_kw = dict(cs_rebin_ang=0.1)
    cfg = dataclasses.replace(TCFG, **cfg_kw)
    paths = thydro.HydroPaths(filepath=str(tmp_path / "forced") + "/", mc_path="MC/")
    factory = tdriver.default_synthetic_factory(cfg, par, **GRID)
    kw = dict(chunk_rounds=8, device="cpu", output="npz", mesh=mesh,
              synthetic_frame_factory=factory)
    work = tdriver.run_rank(cfg, par, paths, last_frame_override=10, **kw)
    os.remove(tck.checkpoint_path(work.mc_dir, 0))
    state, photons = tck.read_checkpoint(work.mc_dir, 0)
    photons["ptype"][photons["ptype"] == int(tt.PhotonType.INJECTED)] = int(
        tt.PhotonType.UNABSORBED_CS)
    tck.save_checkpoint(work.mc_dir, 0, state, photons)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="mcrat_tpu_torch"):
        tdriver.run_rank(cfg, dataclasses.replace(par, restart="c", max_photons=200,
                                                  last_frame=12), paths, **kw)
    rows = [r.frame_timing for r in caplog.records if hasattr(r, "frame_timing")]
    assert [t["scatt_frame"] for t in rows] == [11, 12]
    assert sum(t["n_merged_mid"] for t in rows) > 0 and sum(t["n_merged_end"] for t in rows) > 0
    for f in (11, 12):
        data = tph.read_frame(os.path.join(work.mc_dir, "mc_proc_0", str(f), "0.npz"))
        assert b"p" not in set(data["PT"].tolist()) and (data["PW"] > 0).all()
