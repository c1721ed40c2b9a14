"""The port's command line on the CPU: ``run --device cpu --output npz
--merge`` of tests/test_driver.py's mc.par (the full 384 x 64 default grid,
one angle bin, frames 10-12), then ``merge`` of the angle directory and of
the MC base directory (ALL_DATA), and ``status``; ``run --cyclosynchrotron``;
``--mesh 1 --coordinator`` (a process group of one) and ``--dtype
float64`` run, and ``--mesh 2`` with one CPU shard a process raises."""
import contextlib
import dataclasses
import io
import json
import os
import socket

import pytest
import torch

from mcrat_tpu_torch import cli, convert
from mcrat_tpu_torch.io import mcpar as tmcpar
from mcrat_tpu_torch.io import photons_h5 as tph

from test_driver import _par

torch.set_num_threads(1)

RUN = ["--sim", "synthetic", "--geometry", "spherical", "--dims", "2",
       "--simulation-type", "spherical_outflow", "--chunk-rounds", "0"]


def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(list(argv)) == 0
    return out.getvalue()


def test_run_merge_status(tmp_path):
    par = dataclasses.replace(convert.mcpar_from_reference(_par()), n_theta_bins=1,
                              frm0=(10,), frm2=(10,), inj_radius=(8e12,))
    mcpar = str(tmp_path / "mc.par")
    tmcpar.write_mcpar(par, mcpar)
    out = _cli("run", "--mcpar", mcpar, "--filepath", str(tmp_path) + "/", *RUN,
               "--last-frame", "12", "--device", "cpu", "--output", "npz", "--merge")
    counts = json.loads(out.splitlines()[-1])
    assert sorted(counts) == ["10", "11", "12"] and len(set(counts.values())) == 1
    n = counts["10"]
    assert n >= par.min_photons
    adir = tmp_path / "MC" / "0-6"
    for fr in (10, 11, 12):
        data = tph.read_frame(str(adir / f"mcdata_{fr}.npz"))
        assert len(data["P0"]) == n and (data["PW"] > 0).all()
    # merge again: the angle directory (idempotent), then the base (ALL_DATA)
    assert json.loads(_cli("merge", str(adir))) == counts
    assert json.loads(_cli("merge", str(tmp_path / "MC"), "--frames", "11:12")) == {
        "11": n, "12": n}
    assert os.path.exists(tmp_path / "MC" / "ALL_DATA" / "mcdata_12.npz")
    report = json.loads(_cli("status", str(tmp_path / "MC"), "--last-frame", "12"))
    assert report == {"0-6": {"0": dict(inj_frame=11, frm2=10, scatt_frame=11, progress=10 / 12,
                                        done=True, n_photons=0)}}


def test_run_cyclosynchrotron(tmp_path):
    """``run --cyclosynchrotron`` on the 128 x 24 synthetic grid writes
    every frame's dump, without a pool photon in any."""
    par = dataclasses.replace(convert.mcpar_from_reference(_par()), n_theta_bins=1,
                              frm0=(10,), frm2=(10,), inj_radius=(8e12,))
    mcpar = str(tmp_path / "mc.par")
    tmcpar.write_mcpar(par, mcpar)
    out = _cli("run", "--mcpar", mcpar, "--filepath", str(tmp_path) + "/", *RUN,
               "--simulation-type", "cylindrical_outflow", "--cyclosynchrotron",
               "--synthetic-grid", "128", "24", "--last-frame", "12", "--device", "cpu",
               "--output", "npz", "--merge")
    counts = json.loads(out.splitlines()[-1])
    assert sorted(counts) == ["10", "11", "12"] and min(counts.values()) >= par.min_photons
    for fr in (10, 11, 12):
        data = tph.read_frame(str(tmp_path / "MC" / "0-6" / f"mcdata_{fr}.npz"))
        assert b"p" not in set(data["PT"].tolist()) and (data["PW"] > 0).all()


@pytest.mark.parametrize("flags,item", [(["--mesh", "2"], "item 13"),
                                        (["--mesh", "1", "--coordinator", "PORT", "--num-hosts",
                                          "1", "--host-id", "0"], "item 13"),
                                        (["--dtype", "float64"], "item 5")])
def test_unported_options_raise(tmp_path, flags, item):
    """The several-device options (item 13, ported: the mesh) run: ``--mesh
    1 --coordinator`` joins a process group of one (gloo on the CPU) and
    writes the run; ``--mesh 2`` on the CPU, one shard a process, raises
    ValueError before anything is written; ``--dtype float64`` (item 5,
    ported: the XLA engine) runs."""
    mcpar = str(tmp_path / "mc.par")
    tmcpar.write_mcpar(convert.mcpar_from_reference(_par()), mcpar)
    flags = [f"127.0.0.1:{_free_port()}" if f == "PORT" else f for f in flags]
    argv = ["run", "--mcpar", mcpar, "--filepath", str(tmp_path) + "/", *RUN, "--device", "cpu",
            "--output", "npz", *flags]
    if flags != ["--mesh", "2"]:
        assert cli.main(argv + ["--last-frame", "10"]) == 0
        assert sorted(os.listdir(tmp_path)) == ["MC", "mc.par"]
        assert not torch.distributed.is_initialized()
        return
    with pytest.raises(ValueError, match="one shard"):
        cli.main(argv)
    assert os.listdir(tmp_path) == ["mc.par"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
