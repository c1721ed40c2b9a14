"""The port's driver on a mesh of two processes on the CPU (torch.distributed
with gloo, one CPU shard each): one logical rank's photon axis over both,
as tests/test_multihost.py runs the JAX package's over two
jax.distributed processes.

An uninterrupted run through ``python -m mcrat_tpu_torch.cli run --mesh 2
--coordinator ... --num-hosts 2 --host-id P --device cpu``; then the same
configuration through ``driver.run_rank(mesh=)`` in a worker script, run
through frame 11 (the "kill": the ``.old`` checkpoint of frame 11 is
restored over the injection-complete marker), resumed to frame 12 and
merged.  Checks: each process's command exits 0 (each with its own
timeout, so a desynchronised pair fails here instead of hanging); process
1 opens no file for writing, makes, renames or removes none under the run
directory (an audit hook); the dumps of frames 10-12 of the resumed run
equal the uninterrupted run's bit for bit; the merged files hold every
photon, both shards held photons.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from mcrat_tpu_torch import McPar, Spectrum, write_mcpar
from mcrat_tpu_torch.io import photons_h5 as tph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120  # each process

# the run directory's writes made by a process other than 0 (audit events)
AUDIT = textwrap.dedent("""
    import json, os, sys
    WRITES = []

    def _audit(root):
        root = os.path.realpath(root)
        write_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND

        def under(path):
            try:
                return os.path.realpath(os.fsdecode(path)).startswith(root)
            except TypeError:
                return False

        def hook(event, args):
            if event == "open" and args and args[0] is not None and not isinstance(args[0], int):
                mode, flags = args[1], args[2] or 0
                writes = (isinstance(mode, str) and any(c in mode for c in "wax+")) or (
                    flags & write_flags)
                if writes and under(args[0]):
                    WRITES.append((event, os.fsdecode(args[0])))
            elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove", "os.rmdir",
                           "shutil.rmtree") and args and under(args[0]):
                WRITES.append((event, os.fsdecode(args[0])))

        sys.addaudithook(hook)
""")

WORKER = AUDIT + textwrap.dedent("""
    pid, port, outdir, phase = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    sys.path.insert(0, {repo!r})
    if pid != 0:
        _audit(outdir)
    import torch
    torch.set_num_threads(1)
    from mcrat_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown_distributed
    init_distributed(f"127.0.0.1:{{port}}", 2, pid, device="cpu", timeout_s=60)
    mesh = make_mesh(devices=["cpu"])
    assert (mesh.n_shards, mesh.first, mesh.process_count) == (2, pid, 2)
    from mcrat_tpu_torch import Config, Dims, Geometry, SimType, read_mcpar
    from mcrat_tpu_torch.driver import default_synthetic_factory, merge_rank_outputs, run_rank
    from mcrat_tpu_torch.io.hydro import HydroPaths
    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 simulation_type=SimType.SPHERICAL_OUTFLOW)
    par = read_mcpar(os.path.join(outdir, "mc.par"))
    paths = HydroPaths(filepath=outdir + "/", mc_path="MC/")
    factory = default_synthetic_factory(cfg, par, nr=96, ntheta=16)
    work = run_rank(cfg, par, paths, chunk_rounds=8, synthetic_frame_factory=factory,
                    device="cpu", output="npz", mesh=mesh,
                    last_frame_override=11 if phase == "start" else 12)
    if phase == "resume" and pid == 0:
        print("MERGED " + json.dumps(merge_rank_outputs(work, par, last_frame=12)), flush=True)
    print("LAUNCHES " + json.dumps(dict(mesh.launches)), flush=True)
    shutdown_distributed()
    print("WRITES " + json.dumps(WRITES), flush=True)
    print(f"WORKER_OK pid={{pid}} phase={{phase}}", flush=True)
""")

# the CLI's run, under the same audit
CLI = AUDIT + textwrap.dedent("""
    pid, outdir = int(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, {repo!r})
    if pid != 0:
        _audit(outdir)
    from mcrat_tpu_torch import cli
    rc = cli.main(sys.argv[3:])
    print("WRITES " + json.dumps(WRITES), flush=True)
    print(f"WORKER_OK pid={{pid}} rc={{rc}}", flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _pair(argvs):
    """Both processes' commands, each with its own timeout; every process is
    stopped before this returns.  Returns their outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK" in out, f"process {pid}:\n{out[-4000:]}"
    writes = [json.loads(line[7:]) for line in outs[1].splitlines() if line.startswith("WRITES ")]
    assert writes == [[]], f"process 1 wrote under the run directory: {writes}"
    return outs


def _par(restart="i"):
    return McPar(fps=5.0, last_frame=12, r0_domain=(1e12, 5e13), r1_domain=(0.0, 1.0),
                 r2_domain=(0.0, 0.0), theta_min_deg=0.0, theta_max_deg=6.0, n_theta_bins=1,
                 frm0=(10,), frm2=(10,), inj_radius=(8e12,), spect=Spectrum.BLACKBODY,
                 min_photons=600, max_photons=1500, restart=restart)


def _dumps(mc_dir, frame):
    return tph.read_frame(os.path.join(mc_dir, "mc_proc_0", str(frame), "0.npz"))


@pytest.mark.slowish
def test_two_process_mesh_driver_resume_and_merge(tmp_path):
    # the uninterrupted run, through the command line
    full = tmp_path / "full"
    full.mkdir()
    write_mcpar(_par(), str(full / "mc.par"))
    script = tmp_path / "cli.py"
    script.write_text(CLI.format(repo=REPO))
    port = _free_port()
    argv = ["run", "--mcpar", str(full / "mc.par"), "--filepath", str(full) + "/",
            "--sim", "synthetic", "--geometry", "spherical", "--dims", "2",
            "--simulation-type", "spherical_outflow", "--synthetic-grid", "96", "16",
            "--chunk-rounds", "8", "--last-frame", "12", "--device", "cpu", "--output", "npz",
            "--mesh", "2", "--coordinator", f"127.0.0.1:{port}", "--num-hosts", "2"]
    outs = _pair([[str(script), str(pid), str(full), *argv, "--host-id", str(pid)]
                  for pid in (0, 1)])
    full_dir = str(full / "MC" / "0-6")

    # the same run through run_rank(mesh=), killed after frame 11, resumed
    run = tmp_path / "run"
    run.mkdir()
    write_mcpar(_par(), str(run / "mc.par"))
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO))

    def phase(name):
        port = _free_port()
        return _pair([[str(script), str(pid), str(port), str(run), name] for pid in (0, 1)])

    phase("start")
    mc_dir = str(run / "MC" / "0-6")
    assert tph.discover_frames(tph.list_proc_files(mc_dir)) == [10, 11]
    chk = os.path.join(mc_dir, "mc_chkpt_0.npz")
    os.replace(chk + ".old", chk)
    write_mcpar(_par("c"), str(run / "mc.par"))
    outs = phase("resume")
    assert tph.discover_frames(tph.list_proc_files(mc_dir)) == [10, 11, 12]
    for frame in (10, 11, 12):
        got, want = _dumps(mc_dir, frame), _dumps(full_dir, frame)
        assert sorted(got) == sorted(want)
        differ = [k for k in want if not np.array_equal(got[k], want[k])]
        assert not differ, (frame, differ)
    merged = [json.loads(line[7:]) for out in outs for line in out.splitlines()
              if line.startswith("MERGED ")]
    assert len(merged) == 1 and sorted(merged[0]) == ["10", "11", "12"]
    data = tph.read_frame(os.path.join(mc_dir, "mcdata_12.npz"))
    n = merged[0]["12"]
    assert n >= 600 and len(data["PW"]) == n and (data["PW"] > 0).all()
    assert np.isfinite(data["P0"]).all() and data["NS"].mean() > 0
    # both shards held photons: each run of the injection scattered
    ns = data["NS"]
    assert ns[: n // 2].sum() > 0 and ns[n // 2:].sum() > 0
