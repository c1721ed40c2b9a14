"""The port's cyclo-synchrotron driver against mcrat_tpu's, on the CPU.

The run is tests/test_driver.py's ``_par()`` (the 2-D spherical grid of
``default_synthetic_factory`` cut to 128 x 24 cells, injections at frames 10
and 11, frames to 13, a few hundred photons an injection) with
tests/test_cyclosynch.py's physics: the cylindrical outflow, cyclo-synchrotron
on, TOTAL_E field with eps_B = 0.5, float32, ``device="cpu"`` (the
fused-round kernel's plain twin).

* End to end against JAX's float32 ``run_rank``: the per-frame mean P0 and
  mean radius within 5 standard errors of the mean, 5 sigma / sqrt(N) (the
  two transport engines draw different random numbers, so the promoted pool
  photons, their replacements and, after them, the second injection differ);
  frame 10's photon count exact; no pool photon in a dump; the first frame's
  pool emission equals JAX's array for array (both draw it from the same
  numpy stream after the same injection).
* A resume after a crash equals the uninterrupted run bit for bit (F9 with
  emission in the stream, and F11: the JAX package skips the first frame
  after a resume's cyclo-synchrotron steps).
* F3: the advected shell takes the schedule's fps, not ``par.fps``.
"""
import dataclasses
import logging
import math
import os

import numpy as np
import torch

from mcrat_tpu import driver as jdriver
from mcrat_tpu.config import BFieldCalc, Config, Dims, Geometry, SimType
from mcrat_tpu.io import hydro as jhydro
from mcrat_tpu.io import photons_h5 as jh5
from mcrat_tpu.ops import cyclosynch as jcs
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import driver as tdriver
from mcrat_tpu_torch.config import PhotonType
from mcrat_tpu_torch.io import checkpoint as tck
from mcrat_tpu_torch.io import hydro as thydro
from mcrat_tpu_torch.io import photons_h5 as tph
from mcrat_tpu_torch.ops import cyclosynch as tcs

from test_driver import _par

torch.set_num_threads(1)

CFG = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
             simulation_type=SimType.CYLINDRICAL_OUTFLOW, cyclosynchrotron=True,
             b_field_calc=BFieldCalc.TOTAL_E, epsilon_b=0.5, dtype="float32")
TCFG = convert.config_from_reference(CFG)
GRID = dict(nr=128, ntheta=24)


def _tpar(restart="i", **kw):
    return dataclasses.replace(convert.mcpar_from_reference(_par(restart)), **kw)


def _run(tmp_path, par, **kw):
    paths = thydro.HydroPaths(filepath=str(tmp_path) + "/", mc_path="MC/")
    factory = tdriver.default_synthetic_factory(TCFG, par, **GRID)
    kw = {"rank": 0, "num_ranks": 2, "chunk_rounds": 0, "device": "cpu", "output": "npz", **kw}
    return tdriver.run_rank(TCFG, par, paths, synthetic_frame_factory=factory, **kw)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, spy)


def test_run_rank_cyclosynchrotron_against_jax(tmp_path, caplog, monkeypatch):
    tcalls, jcalls = [], []
    _spy(monkeypatch, tcs, "emit_pool_photons", tcalls)
    _spy(monkeypatch, jcs, "emit_pool_photons", jcalls)
    par = _tpar()
    with caplog.at_level(logging.INFO, logger="mcrat_tpu_torch"):
        work = _run(tmp_path / "port", par)
    rows = [r.frame_timing for r in caplog.records if hasattr(r, "frame_timing")]
    assert [(t["frame"], t["scatt_frame"]) for t in rows] == [
        (10, 10), (10, 11), (10, 12), (10, 13), (11, 11), (11, 12), (11, 13)]
    for t in rows:
        cs_frame = t["scatt_frame"] != t["frame"]
        assert (t["n_pool_emitted"] > 0) == cs_frame
        assert t["n_pool_replaced"] == t["n_promoted"] >= 0
        assert min(t[k] for k in ("transport_s", "emission_s", "rebin_s", "absorption_s")) >= 0
    assert sum(t["n_promoted"] for t in rows) > 0  # pool lanes scatter and are promoted
    assert sum(t["n_absorbed"] for t in rows) > 0
    counts = tdriver.merge_rank_outputs(work, par)

    jpaths = jhydro.HydroPaths(filepath=str(tmp_path / "jax") + "/", mc_path="MC/")
    jwork = jdriver.run_rank(
        CFG, _par(), jpaths, rank=0, num_ranks=2, chunk_rounds=0, progress=False,
        synthetic_frame_factory=jdriver.default_synthetic_factory(CFG, _par(), **GRID))
    jcounts = jdriver.merge_rank_outputs(jwork, _par())
    assert sorted(counts) == sorted(jcounts) == [10, 11, 12, 13]
    for fr in (10, 11, 12, 13):
        got = tph.read_frame(os.path.join(work.mc_dir, f"mcdata_{fr}.npz"))
        want = jh5.read_frame(os.path.join(jwork.mc_dir, f"mcdata_{fr}.h5"))
        assert sorted(got) == sorted(want) and len(got["P0"]) >= 300
        assert b"p" not in set(got["PT"].tolist()) and (got["PW"] > 0).all()
        if fr == 10:  # the first injection alone, before the streams part
            assert len(got["P0"]) == len(want["P0"])
        for k, a, b in (("P0", got["P0"], want["P0"]),
                        ("r", *(np.sqrt(d["R0"] ** 2 + d["R1"] ** 2 + d["R2"] ** 2)
                                for d in (got, want)))):
            assert abs(a.mean() - b.mean()) <= 5 * a.std() / math.sqrt(len(a)), (fr, k)
    # the first emission: the same numpy stream after the same injection
    (targs, (tarr, tw)), (jargs, (jarr, jw)) = tcalls[0], jcalls[0]
    assert targs[2:4] == jargs[2:4] == (11, 10) and tw == jw and len(tarr["weight"]) >= 1
    for k in jarr:
        np.testing.assert_allclose(tarr[k], jarr[k], rtol=1e-12, atol=0, err_msg=k)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """One injection, frames 10-13; a crash right after frame 11's
    checkpoint leaves only its .old file.  The continued run runs frame 12's
    cyclo-synchrotron steps (F11: the JAX package skips them on the first
    frame after a resume) from the saved random streams (F9), and every
    merged frame equals the uninterrupted run's bit for bit, but for the
    type of the scattered-CS photons the checkpoint carried."""
    par = _tpar(n_theta_bins=1, frm0=(10,), frm2=(10,), inj_radius=(8e12,))
    whole = _run(tmp_path / "whole", par, num_ranks=1)
    part = _run(tmp_path / "crash", par, num_ranks=1, last_frame_override=11)
    os.remove(tck.checkpoint_path(part.mc_dir, 0))
    state, ph = tck.read_checkpoint(part.mc_dir, 0)
    assert (state.restart, state.scatt_frame) == ("c", 12)
    assert (ph["ptype"] == int(PhotonType.UNABSORBED_CS)).any()  # promoted pool photons
    _run(tmp_path / "crash", dataclasses.replace(par, restart="c"), num_ranks=1)
    for fr in (10, 11, 12, 13):
        n = tph.merge_frame(whole.mc_dir, fr)
        assert tph.merge_frame(part.mc_dir, fr) == n > 0
        got = tph.read_frame(os.path.join(part.mc_dir, f"mcdata_{fr}.npz"))
        want = tph.read_frame(os.path.join(whole.mc_dir, f"mcdata_{fr}.npz"))
        assert sorted(got) == sorted(want)
        # a checkpoint stores COMPTONIZED photons as UNABSORBED_CS (the JAX
        # package's layout), so the resumed frames say 'c' where the
        # uninterrupted run says 'k'
        for d in (got, want):
            d["PT"] = np.where(d["PT"] == b"k", b"c", d["PT"])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(fr, k))


def test_shell_takes_the_schedules_fps(tmp_path, monkeypatch):
    """F3: the JAX driver advects the pool's shell at par.fps; the port at
    the fps of its frame schedule (here a schedule at half of par.fps), as
    it loads the frame."""
    par = _tpar(n_theta_bins=1, frm0=(10,), frm2=(10,), inj_radius=(8e12,))
    sched = tdriver.FrameSchedule(base_fps=par.fps / 2)
    monkeypatch.setattr(tdriver, "make_frame_schedule", lambda cfg, par: sched)
    fps = []
    limits = tcs.cs_r_limits
    monkeypatch.setattr(tcs, "cs_r_limits", lambda s, i, f, r: fps.append(f) or limits(s, i, f, r))
    _run(tmp_path, par, num_ranks=1, last_frame_override=11)
    assert fps and set(fps) == {par.fps / 2}
