"""The port's driver against mcrat_tpu's, on the CPU at a small size.

The runs are tests/test_driver.py's: the 2-D spherical outflow on
``default_synthetic_factory``'s grid cut to 128 x 24 cells, two angle bins,
injections at frames 10 and 11, frames to 13, a few hundred photons an
injection, float32, ``device="cpu"`` (the fused-round kernel's plain twin).

* Exact: ``decompose_work`` over ranks x bins and ``FrameSchedule`` (RIKEN
  3-D included) against JAX; the three ``clean_initialize_dir`` scenarios.
* End to end: the per-frame photon counts equal JAX's ``run_rank`` (float32,
  the XLA engine) exactly; the per-frame mean P0 and mean radius agree within
  5 standard errors of the mean, 5 sigma / sqrt(N) (the two engines draw
  different random numbers); the first frame's dump equals a hand-sequenced
  inject + ``transport_frame`` photon for photon.
* Every frame logs one ``frame_timing`` record with the writer's fetch,
  checkpoint and dump seconds.
* Restart from a crafted checkpoint dumps only frames 12 and 13; a resume
  after a crash continues the random streams (fault F9): the same transport
  seeds and the same frames as the run that was not interrupted, and an
  injection after the resume draws the photons the uninterrupted run drew.
* Elastic re-adoption runs the unfinished old rank under its old id.
* Cyclo-synchrotron runs; float64 runs (the XLA engine, held against JAX in
  test_torch_float64_driver); HDF5 without h5py and a run without a card
  raise before anything is written.
* ``get_hydro_data`` of a FLASH file (the reader, the test-problem overwrite
  and the nonthermal densities) gives JAX's frame field for field.
"""
import dataclasses
import logging
import math
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mcrat_tpu import driver as jdriver
from mcrat_tpu.config import (Config, Dims, Geometry, HydroSim, NonthermalDist, SimType,
                              TauCalculation)
from mcrat_tpu.io import hydro as jhydro
from mcrat_tpu.io import photons_h5 as jh5
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import driver as tdriver
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.io import checkpoint as tck
from mcrat_tpu_torch.io import hydro as thydro
from mcrat_tpu_torch.io import photons_h5 as tph

from test_driver import _par
from test_torch_amr_flash import _assert_same_frame, flash_file  # noqa: F401

torch.set_num_threads(1)

CFG = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
             simulation_type=SimType.SPHERICAL_OUTFLOW, dtype="float32")
TCFG = convert.config_from_reference(CFG)
GRID = dict(nr=128, ntheta=24)


def _tpar(restart="i", **kw):
    return dataclasses.replace(convert.mcpar_from_reference(_par(restart)), **kw)


def _run(tmp_path, par, cfg=TCFG, **kw):
    paths = thydro.HydroPaths(filepath=str(tmp_path) + "/", mc_path="MC/")
    factory = tdriver.default_synthetic_factory(cfg, par, **GRID)
    kw = {"rank": 0, "num_ranks": 2, "chunk_rounds": 0, "device": "cpu", "output": "npz", **kw}
    return tdriver.run_rank(cfg, par, paths, synthetic_frame_factory=factory, **kw)


def _proc_frames(work, rank=0):
    return tph.discover_frames(tph.list_proc_files(work.mc_dir)) if rank is None else \
        tph.discover_frames([p for p in tph.list_proc_files(work.mc_dir)
                             if os.path.basename(p).startswith(f"mc_proc_{rank}")])


# ---------------------------------------------------------------------------
# exact against JAX


@pytest.mark.parametrize("num_ranks", [1, 2, 3, 4, 5, 8])
def test_decompose_work_identical_to_jax(tmp_path, num_ranks):
    par = _par()
    par = dataclasses.replace(par, frm0=(10, 12), frm2=(14, 13), inj_radius=(8e12, 9e12))
    for rank in range(num_ranks):
        want = jdriver.decompose_work(par, rank, num_ranks, str(tmp_path))
        got = tdriver.decompose_work(convert.mcpar_from_reference(par), rank, num_ranks,
                                     str(tmp_path))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("sim,dims,fps", [("synthetic", 2, 5.0), ("riken", 3, 5.0),
                                          ("riken", 2, 10.0), ("flash", 2, 2.0)])
def test_frame_schedule_identical_to_jax(sim, dims, fps):
    dim = {2: Dims.TWO, 3: Dims.THREE}[dims]
    geom = Geometry.SPHERICAL
    cfg = Config(sim_switch=HydroSim(sim), dims=dim, geometry=geom)
    par = dataclasses.replace(_par(), fps=fps)
    want = jdriver.make_frame_schedule(cfg, par)
    got = tdriver.make_frame_schedule(convert.config_from_reference(cfg),
                                      convert.mcpar_from_reference(par))
    assert (got.base_fps, got.riken3d) == (want.base_fps, want.riken3d)
    for first, last in ((2990, 3030), (0, 12), (3004, 3050)):
        assert list(got.frames(first, last)) == list(want.frames(first, last))
    for frame in (0, 7, 2999, 3000, 3005, 3010, 3040):
        assert got.step(frame) == want.step(frame) and got.next(frame) == want.next(frame)
        assert got.inj_time(frame) == want.inj_time(frame)
        for inj in (0, 2999, 3000, 3010):
            assert got.end_time(frame, inj_frame=inj) == want.end_time(frame, inj_frame=inj)


# ---------------------------------------------------------------------------
# end to end


def _frame_stats(data):
    r = np.sqrt(data["R0"] ** 2 + data["R1"] ** 2 + data["R2"] ** 2)
    return {"P0": data["P0"], "r": r}


def test_run_rank_end_to_end_against_jax(tmp_path, caplog):
    par = _tpar()
    with caplog.at_level(logging.INFO, logger="mcrat_tpu_torch"):
        work = _run(tmp_path / "port", par)
    rows = [r.frame_timing for r in caplog.records if hasattr(r, "frame_timing")]
    assert [(t["frame"], t["scatt_frame"]) for t in rows] == [
        (10, 10), (10, 11), (10, 12), (10, 13), (11, 11), (11, 12), (11, 13)]
    for t in rows:
        assert t["n_photons"] >= par.min_photons
        assert min(t[k] for k in ("transport_s", "persist_wait_s", "fetch_s", "checkpoint_s",
                                  "dump_s")) >= 0.0
    assert work.framestart == 10 and work.frm2 == 11
    assert os.path.exists(os.path.join(work.mc_dir, "mc_chkpt_0.npz"))
    assert os.path.exists(os.path.join(work.mc_dir, "mc_output_0.log"))
    assert _proc_frames(work) == [10, 11, 12, 13]
    counts = tdriver.merge_rank_outputs(work, par)
    assert sorted(f for f, n in counts.items() if n) == [10, 11, 12, 13]

    jpaths = jhydro.HydroPaths(filepath=str(tmp_path / "jax") + "/", mc_path="MC/")
    jwork = jdriver.run_rank(
        CFG, _par(), jpaths, rank=0, num_ranks=2, chunk_rounds=0, progress=False,
        synthetic_frame_factory=jdriver.default_synthetic_factory(CFG, _par(), **GRID))
    jcounts = jdriver.merge_rank_outputs(jwork, _par())
    assert counts == jcounts
    for fr in (10, 11, 12, 13):
        got = tph.read_frame(os.path.join(work.mc_dir, f"mcdata_{fr}.npz"))
        want = jh5.read_frame(os.path.join(jwork.mc_dir, f"mcdata_{fr}.h5"))
        assert sorted(got) == sorted(want) and len(got["P0"]) == len(want["P0"]) >= 300
        assert (got["PW"] > 0).all() and (got["P0"] > 0).all()
        np.testing.assert_allclose(got["PW"].sum(), want["PW"].sum(), rtol=1e-6)
        a, b = _frame_stats(got), _frame_stats(want)
        n = len(got["P0"])
        for k in a:
            # 5 standard errors of the mean
            assert abs(a[k].mean() - b[k].mean()) <= 5 * a[k].std() / math.sqrt(n), (fr, k)

    # the first frame: a hand-sequenced inject + transport_frame of the same code
    host, edges = tdriver.default_synthetic_factory(TCFG, par, **GRID)(10)
    arrays, _ = tt.inject_photons(host, work.r_inj, 1e50, par.min_photons, par.max_photons,
                                  par.spect, work.theta_min, work.theta_max, par.fps,
                                  np.random.default_rng(9876))
    cap = int(2 ** math.ceil(math.log2(len(arrays["weight"]) * TCFG.capacity_factor)))
    photons, meta = tt.photons_from_arrays(arrays, capacity=cap, device="cpu")
    res = tt.transport_frame(TCFG, photons, host.to_device("cpu"),
                             thydro.build_index(TCFG, host, edges, device="cpu"),
                             (10 + 1) / par.fps - 10 / par.fps, torch.Generator().manual_seed(1234),
                             chunk_rounds=0, fused=True)
    hand = tph.dump_arrays(TCFG, convert.photons_to_numpy(res.photons), meta)
    first = tph.read_frame(os.path.join(work.mc_dir, "mc_proc_0", "10", "0.npz"))
    assert sorted(first) == sorted(hand)
    for k in hand:
        np.testing.assert_array_equal(first[k], hand[k], err_msg=k)


def test_restart_continue_from_a_crafted_checkpoint(tmp_path):
    """A mid-run kill: the checkpoint an interrupted rank leaves (restart c,
    scattering loop at frame 12); the continued run dumps 12 and 13 only."""
    par = _tpar(restart="c")
    work = tdriver.decompose_work(par, 0, 4, str(tmp_path) + "/MC/")
    os.makedirs(work.mc_dir)
    host, _ = tdriver.default_synthetic_factory(TCFG, par, **GRID)(10)
    arrays, _ = tt.inject_photons(host, work.r_inj, 1e50, par.min_photons, par.max_photons,
                                  par.spect, work.theta_min, work.theta_max, par.fps,
                                  np.random.default_rng(1))
    ph, meta = tt.photons_from_arrays(arrays, device="cpu")
    tck.save_checkpoint(work.mc_dir, 0, tck.CheckpointState(
        frame=10, frm2=work.frm2, scatt_frame=12, time_now=12 / par.fps, restart="c",
        weight_norm=meta.weight_norm, n_injected=meta.n_injected), convert.photons_to_numpy(ph))
    work2 = _run(tmp_path, par, num_ranks=4, output="h5")
    assert work2.mc_dir == work.mc_dir
    import h5py

    with h5py.File(os.path.join(work.mc_dir, "mc_proc_0.h5")) as f:
        assert sorted(int(k) for k in f.keys()) == [12, 13]
        assert f["13"]["P0"].shape[0] == len(arrays["weight"])


def test_resume_after_a_crash_continues_the_random_streams(tmp_path, monkeypatch):
    """One injection, frames 10-13.  A crash right after frame 11's
    checkpoint leaves only its .old file; the continued run draws the
    transport seeds the uninterrupted run drew for frames 12 and 13 (not
    frame 10's again, fault F9) and, at this capacity, dumps the same
    photons bit for bit."""
    seeds = []
    draw = tt.draw_seed
    monkeypatch.setattr(tt, "draw_seed", lambda g: seeds.append(draw(g)) or seeds[-1])
    par = _tpar(n_theta_bins=1, frm0=(10,), frm2=(10,), inj_radius=(8e12,))
    whole = _run(tmp_path / "whole", par, num_ranks=1)
    whole_seeds = list(seeds)
    assert len(whole_seeds) == 4  # one chunk a frame
    seeds.clear()
    part = _run(tmp_path / "crash", par, num_ranks=1, last_frame_override=11)
    os.remove(tck.checkpoint_path(part.mc_dir, 0))
    state, _ = tck.read_checkpoint(part.mc_dir, 0)
    assert (state.restart, state.scatt_frame) == ("c", 12)
    # the kernel's run draws no threefry key, so it checkpoints none
    assert state.generator_state is not None and state.key_state is None
    _run(tmp_path / "crash", dataclasses.replace(par, restart="c"), num_ranks=1)
    assert seeds == whole_seeds
    for fr in (10, 11, 12, 13):
        a = tph.merge_frame(whole.mc_dir, fr)
        assert tph.merge_frame(part.mc_dir, fr) == a > 0
        got = tph.read_frame(os.path.join(part.mc_dir, f"mcdata_{fr}.npz"))
        want = tph.read_frame(os.path.join(whole.mc_dir, f"mcdata_{fr}.npz"))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(fr, k))


def test_injection_after_a_resume_continues_the_injection_stream(tmp_path, monkeypatch):
    """Injections at frames 10 and 11, frames to 13.  The first run crashes
    in injection 10's frame 12, after frame 11's checkpoint; the continued
    run finishes injection 10, then injects at frame 11 from the injection
    generator's saved state (fault F9: reseeded, it would draw injection
    10's photons again).  Every merged frame equals the uninterrupted run's
    bit for bit."""
    par = _tpar(n_theta_bins=1, frm0=(10,), frm2=(11,), inj_radius=(8e12,))
    whole = _run(tmp_path / "whole", par, num_ranks=1)
    frame_fn = tt.transport_frame
    calls = []

    def crash_on_third(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("crash in frame 12")
        return frame_fn(*args, **kwargs)

    monkeypatch.setattr(tt, "transport_frame", crash_on_third)
    with pytest.raises(RuntimeError, match="crash in frame 12"):
        _run(tmp_path / "crash", par, num_ranks=1)
    monkeypatch.setattr(tt, "transport_frame", frame_fn)
    part = tdriver.decompose_work(par, 0, 1, str(tmp_path / "crash" / "MC") + "/")
    state, _ = tck.read_checkpoint(part.mc_dir, 0)
    assert (state.frame, state.restart, state.scatt_frame) == (10, "c", 12)
    assert _proc_frames(part) == [10, 11]
    _run(tmp_path / "crash", dataclasses.replace(par, restart="c"), num_ranks=1)
    for fr in (10, 11, 12, 13):
        n = tph.merge_frame(whole.mc_dir, fr)
        assert tph.merge_frame(part.mc_dir, fr) == n > 0
        got = tph.read_frame(os.path.join(part.mc_dir, f"mcdata_{fr}.npz"))
        want = tph.read_frame(os.path.join(whole.mc_dir, f"mcdata_{fr}.npz"))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(fr, k))
    # frame 11 holds both injections, and they differ
    inj = [tph.read_frame(os.path.join(part.mc_dir, "mc_proc_0", "11", f"{b}.npz"))
           for b in (0, 1)]
    assert not np.array_equal(inj[0]["P0"][:50], inj[1]["P0"][:50])


@pytest.mark.parametrize("sim_type,nonthermal", [("science", False),
                                                 ("cylindrical_outflow", True)])
def test_get_hydro_data_flash_matches_jax(flash_file, sim_type, nonthermal):  # noqa: F811
    """The driver's FLASH frame load: file name, reader and decimation, the
    analytic overwrite and the nonthermal electron densities."""
    path, _ = flash_file
    kw = dict(nonthermal_e_dist=NonthermalDist.POWERLAW, gamma_min=1.0, gamma_max=100.0,
              powerlaw_index=2.5, tau_calculation=TauCalculation.TABLE) if nonthermal else {}
    cfg = Config(sim_switch=HydroSim.FLASH, dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                 hydro_l_scale=1e10, hydro_d_scale=2.0, simulation_type=SimType(sim_type), **kw)
    filepath, name = os.path.split(path)
    fileroot = name[:-4]
    assert thydro.frame_filename(convert.config_from_reference(cfg), thydro.HydroPaths(
        filepath=filepath + "/", fileroot=fileroot), 7) == path
    for args in ((7, 5.0, 1.5e12, True), (7, 5.0, 0.0, False, 1.2e12, 1.3e12, 0.05, 0.2)):
        want = jhydro.get_hydro_data(cfg, jhydro.HydroPaths(filepath=filepath + "/",
                                                            fileroot=fileroot), *args)
        got = thydro.get_hydro_data(convert.config_from_reference(cfg), thydro.HydroPaths(
            filepath=filepath + "/", fileroot=fileroot), *args)
        _assert_same_frame(got, want)
        if nonthermal:
            assert np.asarray(want.nonthermal_dens).any()
            np.testing.assert_allclose(got.nonthermal_dens, np.asarray(want.nonthermal_dens),
                                       rtol=1e-15, atol=0)
        else:
            assert got.nonthermal_dens is None and want.nonthermal_dens is None


def test_elastic_readoption(tmp_path):
    """A dead 2-rank job finished by a 1-rank job: run_elastic adopts
    exactly the unfinished old rank, under its old id."""
    par = _tpar()
    w0 = _run(tmp_path, par)
    base = os.path.dirname(w0.mc_dir)
    w1 = tdriver.decompose_work(par, 1, 2, base)
    os.makedirs(w1.mc_dir, exist_ok=True)
    host, _ = tdriver.default_synthetic_factory(TCFG, par, **GRID)(10)
    arrays, _ = tt.inject_photons(host, w1.r_inj, 1e50, par.min_photons, par.max_photons,
                                  par.spect, w1.theta_min, w1.theta_max, par.fps,
                                  np.random.default_rng(7))
    ph, meta = tt.photons_from_arrays(arrays, device="cpu")
    tck.save_checkpoint(w1.mc_dir, 1, tck.CheckpointState(
        frame=10, frm2=w1.frm2, scatt_frame=12, time_now=12 / par.fps, restart="c",
        weight_norm=meta.weight_norm, n_injected=meta.n_injected), convert.photons_to_numpy(ph))
    items = tdriver.elastic_work_items(par, base, par.last_frame)
    assert [wi.old_rank for _, _, wi in items] == [1]
    paths = thydro.HydroPaths(filepath=str(tmp_path) + "/", mc_path="MC/")
    done = tdriver.run_elastic(
        TCFG, par, paths, rank=0, num_ranks=1, chunk_rounds=0, device="cpu",
        output="npz", synthetic_frame_factory=tdriver.default_synthetic_factory(TCFG, par, **GRID))
    assert len(done) == 1 and done[0].mc_dir == w1.mc_dir
    # resumed at scatt frame 12 of injection 10, then injection 11 in full
    assert _proc_frames(w1, rank=1) == [11, 12, 13]
    assert tdriver.elastic_work_items(par, base, par.last_frame) == []


# ---------------------------------------------------------------------------
# initialize mode: the three clean_initialize_dir scenarios


@pytest.mark.parametrize("output", ["h5", "npz"])
def test_initialize_mode_cleans_stale_output(tmp_path, output):
    """Re-running an initialize job must not append a second copy of every
    frame group; rank 1 is not its directory's cleaner, so it takes the
    ack-wait fallback and removes its own output and the merged files
    (rank 1 of 4 injects at frame 11 alone)."""
    par = _tpar()
    kw = dict(rank=1, num_ranks=4, init_clean_wait_s=0.5, output=output)
    work = _run(tmp_path, par, **kw)
    first = tph.merge_all(work.mc_dir, [11, 12, 13])
    stale = os.path.join(work.mc_dir, f"mcdata_99.{output}")
    os.rename(os.path.join(work.mc_dir, f"mcdata_13.{output}"), stale)
    _run(tmp_path, par, **kw)
    assert not os.path.exists(stale)
    second = tph.merge_all(work.mc_dir, [11, 12, 13])
    for fr, n in first.items():
        assert 0 < second[fr] < 1.5 * n, (fr, n, second[fr])


def test_reinitialize_with_fewer_ranks_sweeps_all(tmp_path):
    """A re-initialize with fewer ranks deletes the other old ranks'
    per-process outputs: the merge then holds the new job's photons only.
    The first job's two ranks run one after the other, so each waits
    ``init_clean_wait_s`` for the other before it goes on alone."""
    par = _tpar()
    w0 = _run(tmp_path, par, rank=0, num_ranks=4, init_clean_wait_s=0.5)
    _run(tmp_path, par, rank=1, num_ranks=4, init_clean_wait_s=0.5)
    assert os.path.isdir(os.path.join(w0.mc_dir, "mc_proc_1"))
    work = _run(tmp_path, par, rank=0, num_ranks=2, init_clean_wait_s=0.5)
    assert not os.path.exists(os.path.join(work.mc_dir, "mc_proc_1"))
    counts = tdriver.merge_rank_outputs(work, par, last_frame=par.last_frame)
    for fr in (10, 11, 12, 13):
        own = tph.merge_frame(work.mc_dir, fr, proc_files=[os.path.join(work.mc_dir,
                                                                          "mc_proc_0")])
        assert counts[fr] == own > 0


def test_initialize_handshake_slow_cleaner_race(tmp_path):
    """A cleaner that starts late still sweeps before the waiting rank
    writes (the ready/ack handshake), stale npz dump directories too."""
    mc_dir = str(tmp_path)
    for name in ("mc_proc_0.h5", "mcdata_11.npz"):
        with open(os.path.join(mc_dir, name), "w") as f:
            f.write("stale")
    os.makedirs(os.path.join(mc_dir, "mc_proc_1", "10"))
    results = {}

    def non_cleaner():
        t0 = time.monotonic()
        results["rm"] = tdriver.clean_initialize_dir(mc_dir, 1, cleaner=False, wait_s=10.0)
        results["dt"] = time.monotonic() - t0
        os.makedirs(os.path.join(mc_dir, "mc_proc_1", "10"))  # fresh output, after the ack

    t = threading.Thread(target=non_cleaner)
    t.start()
    time.sleep(1.0)
    n = tdriver.clean_initialize_dir(mc_dir, 0, cleaner=True, wait_s=10.0,
                                     expected_ranks=[0, 1])
    t.join(timeout=15)
    assert not t.is_alive()
    assert n == 3 and results["rm"] == 0 and results["dt"] < 8.0
    assert os.path.isdir(os.path.join(mc_dir, "mc_proc_1", "10"))
    assert not os.path.exists(os.path.join(mc_dir, "mc_proc_0.h5"))


# ---------------------------------------------------------------------------
# up-front errors


def test_run_rank_runs_cyclosynchrotron(tmp_path):
    """Cyclo-synchrotron is ported: rank 0 of 4 (one injection) runs frames
    10-12 with pool emission and absorption on the default synthetic
    frame (tests/test_torch_cyclosynch_driver.py holds it against JAX)."""
    cfg = dataclasses.replace(TCFG, cyclosynchrotron=True)
    work = _run(tmp_path, _tpar(), cfg=cfg, num_ranks=4, last_frame_override=12,
                init_clean_wait_s=0.1)
    assert _proc_frames(work) == [10, 11, 12]


@pytest.mark.parametrize("case", ["float64", "h5_without_h5py", "format", "no_card"])
def test_unported_runs_raise_before_writing(tmp_path, monkeypatch, case):
    """Runs the port cannot make raise before anything is written; a
    float64 run (ROADMAP item 5, ported) writes its checkpoint and dumps,
    with the HDF5 hydro formats' h5py check passed over (SYNTHETIC)."""
    par = _tpar()
    cfg, kw, err = TCFG, {}, NotImplementedError
    if case == "float64":
        monkeypatch.setitem(sys.modules, "h5py", None)
        work = _run(tmp_path, par, cfg=dataclasses.replace(TCFG, dtype="float64"),
                    last_frame_override=11)
        assert _proc_frames(work) == [10, 11]
        return
    if case == "h5_without_h5py":
        monkeypatch.setitem(sys.modules, "h5py", None)
        kw, err, match = dict(output="h5"), ImportError, "output='npz'"
    elif case == "format":
        kw, err, match = dict(output="hdf5"), ValueError, "output must be"
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        kw, err, match = dict(device=None), RuntimeError, "no CUDA device"
    with pytest.raises(err, match=match):
        _run(tmp_path, par, cfg=cfg, **kw)
    assert not os.listdir(tmp_path)
