"""Command-line entry points (port of ``mcrat_tpu.cli``).

    python -m mcrat_tpu_torch.cli run --mcpar mc.par [--output npz] ...
    python -m mcrat_tpu_torch.cli merge MC/<angle dir> | MC/
    python -m mcrat_tpu_torch.cli status MC/ --last-frame N

replace the reference binaries (MCRAT and MERGE, Makefile:17-28).  Ranks are
independent processes or loop iterations (photon batches never
communicate), so "N ranks" is --rank/--num-ranks.  ``run`` puts its tensors
on ``--device`` (default: the card; ``cpu`` runs the kernel's plain twin)
and dumps photons as ``--output`` h5 (HDF5, needs h5py) or npz (the same
datasets as numpy files).  ``--dtype float64`` transports on the XLA engine
(float32 on the card takes the fused-round kernel).  ``--sim`` reads FLASH,
PLUTO, PLUTO-Chombo or RIKEN frames from ``--filepath``/``--fileroot``, or
makes the SYNTHETIC grid that ``--synthetic-grid NR NTHETA`` sizes
(``driver.default_synthetic_factory``).  ``--mesh N`` shards one rank's
photon axis over N devices of every process (``-1``: every card), each
process taking its own cards (one CPU shard a process with ``--device
cpu``); ``--coordinator host:port``, ``--num-hosts`` and ``--host-id`` join
the processes (``torch.distributed``: NCCL between cards, gloo between CPU
processes), every process running the same command and process 0 alone
writing files.  ``--trace-json PATH`` turns tracing on for the run
(``telemetry.enable(records=True)``: every span's record is kept, ~40-150 a
transport frame) and writes the spans and counters of its frames to PATH at
the end, turning tracing off again.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys



def _build_config(args) -> "Config":
    from .config import (BFieldCalc, Config, Dims, Geometry, HydroSim, NonthermalDist,
                         SimType, TauCalculation)

    dims = {2: Dims.TWO, 25: Dims.TWO_POINT_FIVE, 3: Dims.THREE}[args.dims]
    kw = dict(
        sim_switch=HydroSim(args.sim),
        geometry=Geometry(args.geometry),
        dims=dims,
        simulation_type=SimType(args.simulation_type),
        hydro_l_scale=args.l_scale,
        hydro_d_scale=args.d_scale,
        stokes=not args.no_stokes,
        comv=not args.no_comv,
        save_type=not args.no_save_type,
        tau_calculation=TauCalculation(args.tau),
        cyclosynchrotron=args.cyclosynchrotron,
        b_field_calc=BFieldCalc(args.b_field),
        epsilon_b=args.epsilon_b,
        dtype=args.dtype,
    )
    if args.nonthermal != "off":
        kw.update(
            nonthermal_e_dist=NonthermalDist(args.nonthermal),
            gamma_min=args.gamma_min,
            gamma_max=args.gamma_max,
            powerlaw_index=args.powerlaw_index,
            powerlaw_index_1=args.powerlaw_index_1,
            powerlaw_index_2=args.powerlaw_index_2,
            gamma_break=args.gamma_break,
        )
    return Config(**kw)


def _mesh(args):
    """The run's mesh (None without ``--mesh``) and whether this call joined
    the processes (``--coordinator``; this process's first device made
    current before them)."""
    if not args.mesh:
        return None, False
    import torch
    import torch.distributed as dist

    from .parallel.mesh import init_distributed, local_devices, make_mesh

    dev_type = torch.device(args.device).type
    host_id = args.host_id or 0
    devices = local_devices(args.mesh, dev_type, args.num_hosts, host_id)
    joined = args.coordinator is not None and not dist.is_initialized()
    init_distributed(args.coordinator, args.num_hosts, host_id, device=devices[0])
    return make_mesh(devices=devices), joined


def _status(args) -> int:
    import glob
    import os

    from .io.checkpoint import read_checkpoint

    report = {}
    for adir in sorted(glob.glob(os.path.join(args.base_dir, "*-*"))):
        if not os.path.isdir(adir):
            continue
        ranks = {}
        for path in sorted(glob.glob(os.path.join(adir, "mc_chkpt_*.npz"))):
            rank = int(path.rsplit("_", 1)[1].split(".")[0])
            loaded = read_checkpoint(adir, rank)
            if loaded is None:
                continue
            state, photons = loaded
            ranks[rank] = dict(
                inj_frame=state.frame,
                frm2=state.frm2,
                scatt_frame=state.scatt_frame,
                progress=min(1.0, max(state.scatt_frame - 1, 0) / max(args.last_frame, 1)),
                done=bool(state.frame > state.frm2),
                n_photons=int((photons["weight"] > 0).sum()) if photons is not None else 0,
            )
        report[os.path.basename(adir)] = ranks
    print(json.dumps(report, indent=1))
    return 0


def _merge(args) -> int:
    from .io.photons_h5 import (discover_frames, list_proc_files, merge_across_angles,
                                merge_all)

    frames = None
    if args.frames:
        lo, hi = (int(x) for x in args.frames.split(":"))
        frames = range(lo, hi + 1)
    local_procs = list_proc_files(args.mc_dir)
    if args.all_data or not local_procs:
        # MC base dir: cross-angle merge into ALL_DATA/ (the reference's
        # standalone MERGE binary, Src/merge.c:23-336)
        counts = merge_across_angles(args.mc_dir, frames)
    else:
        counts = merge_all(
            args.mc_dir, frames if frames is not None else discover_frames(local_procs))
    print(json.dumps({str(k): v for k, v in counts.items()}))
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="mcrat_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="run the Monte Carlo radiative transfer")
    run.add_argument("--mcpar", required=True, help="path to mc.par")
    run.add_argument("--filepath", default="./", help="hydro file directory (FILEPATH)")
    run.add_argument("--fileroot", default="", help="hydro file prefix (FILEROOT)")
    run.add_argument("--mc-path", default="MC/", help="output subdirectory (MC_PATH)")
    run.add_argument("--sim", default="synthetic",
                     choices=["flash", "pluto", "pluto_chombo", "riken", "synthetic"])
    run.add_argument("--synthetic-grid", type=int, nargs=2, default=(384, 64),
                     metavar=("NR", "NTHETA"),
                     help="radial and polar cells of the synthetic 2-D spherical grid")
    run.add_argument("--geometry", default="spherical",
                     choices=["cartesian", "spherical", "cylindrical", "polar"])
    run.add_argument("--dims", type=int, default=2, choices=[2, 25, 3])
    run.add_argument("--simulation-type", default="science",
                     choices=["science", "cylindrical_outflow", "spherical_outflow",
                              "structured_spherical_outflow"])
    run.add_argument("--tau", default="direct", choices=["direct", "table"])
    run.add_argument("--cyclosynchrotron", action="store_true")
    run.add_argument("--b-field", default="total_e",
                     choices=["internal_e", "total_e", "simulation"])
    run.add_argument("--epsilon-b", type=float, default=0.5)
    run.add_argument("--nonthermal", default="off",
                     choices=["off", "powerlaw", "brokenpowerlaw"])
    run.add_argument("--gamma-min", type=float)
    run.add_argument("--gamma-max", type=float)
    run.add_argument("--powerlaw-index", type=float)
    run.add_argument("--powerlaw-index-1", type=float)
    run.add_argument("--powerlaw-index-2", type=float)
    run.add_argument("--gamma-break", type=float)
    run.add_argument("--l-scale", type=float, default=1.0)
    run.add_argument("--d-scale", type=float, default=1.0)
    run.add_argument("--no-stokes", action="store_true")
    run.add_argument("--no-comv", action="store_true")
    run.add_argument("--no-save-type", action="store_true")
    run.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    run.add_argument("--rank", type=int, default=0)
    run.add_argument("--num-ranks", type=int, default=1)
    run.add_argument("--last-frame", type=int, default=None,
                     help="override mc.par last frame (short test runs)")
    run.add_argument("--chunk-rounds", type=int, default=256)
    run.add_argument("--ph-weight", type=float, default=1e50,
                     help="initial injection weight before auto-tune")
    run.add_argument("--merge", action="store_true", help="merge after the run")
    run.add_argument("--elastic", action="store_true",
                     help="re-adopt unfinished old-rank checkpoints under this job's "
                          "--num-ranks (any size)")
    run.add_argument("--device", default="cuda",
                     help="torch device of the run (float32 on cpu runs the kernel's "
                          "plain twin)")
    run.add_argument("--output", default="h5", choices=["h5", "npz"],
                     help="photon dump format: HDF5 (needs h5py) or the same datasets "
                          "as numpy files")
    run.add_argument("--mesh", type=int, default=0,
                     help="shard the photon axis over N devices (0 = single device; "
                          "-1 = every card)")
    run.add_argument("--coordinator", default=None,
                     help="multi-process coordinator address host:port "
                          "(torch.distributed, process 0 listens)")
    run.add_argument("--num-hosts", type=int, default=1, help="processes of the mesh")
    run.add_argument("--host-id", type=int, default=None, help="this process's index")
    run.add_argument("--trace-json", default=None, metavar="PATH",
                     help="trace the run's frames (telemetry spans and counters) and write "
                          "their records and summary to PATH as JSON at the end")

    mrg = sub.add_parser("merge", help="merge per-process outputs (the MERGE tool)")
    mrg.add_argument("mc_dir",
                     help="angle directory holding mc_proc_* outputs, or the MC base "
                          "directory of angle dirs (cross-angle merge into ALL_DATA/)")
    mrg.add_argument("--frames", default=None,
                     help="frame range as lo:hi (default: every frame found)")
    mrg.add_argument("--all-data", action="store_true",
                     help="force the cross-angle ALL_DATA merge")

    st = sub.add_parser("status", help="report per-rank progress from checkpoints")
    st.add_argument("base_dir", help="MC output directory (contains angle dirs)")
    st.add_argument("--last-frame", type=int, required=True)

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stderr)

    if args.command == "status":
        return _status(args)
    if args.command == "merge":
        return _merge(args)

    from . import telemetry
    from .config import HydroSim
    from .driver import default_synthetic_factory, merge_rank_outputs, run_elastic, run_rank
    from .io.hydro import HydroPaths
    from .io.mcpar import read_mcpar

    cfg = _build_config(args)
    par = read_mcpar(args.mcpar)
    paths = HydroPaths(filepath=args.filepath, fileroot=args.fileroot, mc_path=args.mc_path)
    nr, ntheta = args.synthetic_grid
    factory = (default_synthetic_factory(cfg, par, nr=nr, ntheta=ntheta)
               if cfg.sim_switch is HydroSim.SYNTHETIC else None)
    from .parallel.mesh import shutdown_distributed

    joined = False
    if args.trace_json:
        telemetry.enable(records=True)
    try:
        mesh, joined = _mesh(args)
        kw = dict(last_frame_override=args.last_frame, chunk_rounds=args.chunk_rounds,
                  synthetic_frame_factory=factory, ph_weight=args.ph_weight,
                  device=args.device, output=args.output, mesh=mesh)
        if args.elastic:
            works = run_elastic(cfg, par, paths, rank=args.rank, num_ranks=args.num_ranks,
                                **kw)
            work = works[-1] if works else None
        else:
            work = run_rank(cfg, par, paths, rank=args.rank, num_ranks=args.num_ranks, **kw)
        if args.merge and work is not None and (mesh is None or mesh.process_index == 0):
            counts = merge_rank_outputs(work, par, last_frame=args.last_frame)
            print(json.dumps({str(k): v for k, v in counts.items()}))
    finally:
        if joined:
            shutdown_distributed()
        if args.trace_json:
            telemetry.enable(False)
            _write_trace(args.trace_json)
    return 0


def _write_trace(path: str) -> None:
    """The run's telemetry records and summary as one JSON file."""
    from . import telemetry

    with open(path, "w") as f:
        json.dump(dict(summary=telemetry.summary(), spans=telemetry.snapshot()), f)


if __name__ == "__main__":
    sys.exit(main())
