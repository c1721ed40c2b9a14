"""The port's float64 driver (the XLA engine) against the JAX package's, on
the CPU at tests/test_driver.py's size.

``run_rank`` of tests/test_driver.py's ``_par()`` (the 2-D spherical outflow
on the 128 x 24 synthetic grid, two angle bins, injections at frames 10 and
11, frames to 13), float64, against JAX's ``run_rank(...,
key=make_key(1234, impl="threefry2x32"))``: the driver protocols split the
key once per transport call, so every frame's merged dump equals JAX's
photon for photon -- counts, types and scatterings exactly, every float
field within rtol 1e-9 of its field's scale (a momentum component near zero
carries its vector's last-place differences).  A resume from the checkpoint
of frame 11 continues the threefry key (fault F9 repaired on this path too):
frames 12 and 13 equal the uninterrupted run's bit for bit.  The CLI runs
the same configuration with ``--dtype float64``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mcrat_tpu import driver as jdriver
from mcrat_tpu.config import Config, Dims, Geometry, SimType
from mcrat_tpu.io import hydro as jhydro
from mcrat_tpu.io import photons_h5 as jh5
from mcrat_tpu.ops.rng import make_key
from mcrat_tpu_torch import cli
from mcrat_tpu_torch import convert
from mcrat_tpu_torch import driver as tdriver
from mcrat_tpu_torch.io import checkpoint as tck
from mcrat_tpu_torch.io import hydro as thydro
from mcrat_tpu_torch.io import mcpar as tmcpar
from mcrat_tpu_torch.io import photons_h5 as tph
from mcrat_tpu_torch.ops import fused_round as fr

from test_driver import _par

torch.set_num_threads(1)

CFG = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
             simulation_type=SimType.SPHERICAL_OUTFLOW, dtype="float64")
TCFG = convert.config_from_reference(CFG)
GRID = dict(nr=128, ntheta=24)
FRAMES = (10, 11, 12, 13)


def _port_run(base, **kw):
    par = dataclasses.replace(convert.mcpar_from_reference(_par()), **kw.pop("par", {}))
    paths = thydro.HydroPaths(filepath=str(base) + "/", mc_path="MC/")
    kw = {"rank": 0, "num_ranks": 2, "chunk_rounds": 0, **kw}
    return tdriver.run_rank(TCFG, par, paths, device="cpu", output="npz",
                            synthetic_frame_factory=tdriver.default_synthetic_factory(
                                TCFG, par, **GRID), **kw), par


def _dump(work, frame, rank=0):
    return tph.read_frame(os.path.join(work.mc_dir, f"mc_proc_{rank}", str(frame), "0.npz"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("f64")
    launches = fr.fused_rounds.launches
    work, par = _port_run(base / "port")
    assert fr.fused_rounds.launches == launches  # the XLA engine, not the kernel
    counts = tdriver.merge_rank_outputs(work, par)
    assert _dump(work, 10)["P0"].dtype == np.float64
    jpaths = jhydro.HydroPaths(filepath=str(base / "jax") + "/", mc_path="MC/")
    jwork = jdriver.run_rank(
        CFG, _par(), jpaths, rank=0, num_ranks=2, chunk_rounds=0, progress=False,
        synthetic_frame_factory=jdriver.default_synthetic_factory(CFG, _par(), **GRID),
        key=make_key(1234, impl="threefry2x32"))
    jcounts = jdriver.merge_rank_outputs(jwork, _par())
    return work, counts, jwork, jcounts


def test_float64_run_rank_equals_jax_frame_for_frame(runs):
    work, counts, jwork, jcounts = runs
    assert counts == jcounts and sorted(counts) == list(FRAMES)
    for frame in FRAMES:
        got = tph.read_frame(os.path.join(work.mc_dir, f"mcdata_{frame}.npz"))
        want = jh5.read_frame(os.path.join(jwork.mc_dir, f"mcdata_{frame}.h5"))
        assert sorted(got) == sorted(want) and len(want["P0"]) >= 300
        for k in want:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            if g.dtype.kind != "f":
                np.testing.assert_array_equal(g, w, err_msg=f"{frame} {k}")
                continue
            np.testing.assert_array_equal(g.shape, w.shape)
            group = [n for n in want if n[:-1] == k[:-1] and n[-1:].isdigit()] or [k]
            scale = np.max([np.abs(np.asarray(want[n])) for n in group], axis=0)
            np.testing.assert_array_less(np.abs(g - w), 1e-9 * scale + 1e-300,
                                         err_msg=f"{frame} {k}")
        np.testing.assert_array_equal(got["NS"], want["NS"])


def test_float64_resume_continues_the_key(tmp_path):
    """One injection, frames 10-13, float64.  A crash right after frame 11's
    checkpoint leaves only its .old file; the continued run takes the key
    that file saved (not a reseeded one, fault F9) and dumps what the
    uninterrupted run dumped, bit for bit."""
    one = dict(n_theta_bins=1, frm0=(10,), frm2=(10,), inj_radius=(8e12,))
    whole, par = _port_run(tmp_path / "whole", num_ranks=1, par=one)
    part, _ = _port_run(tmp_path / "crash", num_ranks=1, last_frame_override=11, par=one)
    os.remove(tck.checkpoint_path(part.mc_dir, 0))
    state, _ = tck.read_checkpoint(part.mc_dir, 0)
    assert (state.restart, state.scatt_frame) == ("c", 12)
    assert state.key_state is not None and state.key_state.dtype == np.uint32
    _port_run(tmp_path / "crash", num_ranks=1, par=dict(one, restart="c"))
    for frame in FRAMES:
        got, want = _dump(part, frame), _dump(whole, frame)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(frame, k))


def test_cli_run_dtype_float64(tmp_path, capsys):
    mcpar = str(tmp_path / "mc.par")
    par = dataclasses.replace(convert.mcpar_from_reference(_par()), n_theta_bins=1,
                              frm0=(10,), frm2=(10,), inj_radius=(8e12,))
    tmcpar.write_mcpar(par, mcpar)
    rc = cli.main(["run", "--mcpar", mcpar, "--filepath", str(tmp_path) + "/",
                   "--simulation-type", "spherical_outflow", "--dtype", "float64",
                   "--synthetic-grid", "128", "24", "--last-frame", "11", "--device", "cpu",
                   "--output", "npz", "--merge", "--chunk-rounds", "0"])
    assert rc == 0
    counts = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert sorted(counts) == ["10", "11"] and min(counts.values()) >= par.min_photons
    data = tph.read_frame(str(tmp_path / "MC" / "0-6" / "mcdata_11.npz"))
    assert data["P0"].dtype == np.float64 and (data["PW"] > 0).all()
    assert np.isfinite(data["P0"]).all() and (data["NS"] > 0).any()
    state, _ = tck.read_checkpoint(str(tmp_path / "MC" / "0-6"), 0)
    assert state.key_state is not None
