#!/usr/bin/env python3
"""How far a resume that reseeds the random streams moves the driver's frames.

The JAX package reseeds both random streams when a run resumes from a
checkpoint (ROADMAP fault F9); the port's checkpoints carry the streams'
states, so its resumed frames equal the uninterrupted run's bit for bit
(chip_smoke.py's driver phase).  This script measures what reseeding does
instead, over several transport seeds, on chip_smoke's driver configuration
with one injection (frame 0, ~1M photons, frames 0-4; ``chip_smoke.
driver_mcpar``).  For each seed s (the transport ``torch.Generator`` seeded
1234 + s; injection from ``default_rng(9876)``, as the driver's rank 0):

  whole      ``driver.run_rank`` through frame 4;
  reseeded   the same run stopped after frame 2, its newest checkpoint
             removed so that the ``.old`` file of frame 2 (restart c,
             scatt frame 3) is left, the stream states taken out of that
             file, then continued to frame 4: the port then reseeds both
             streams, as the JAX package does.

For frames 3 and 4 it prints the mean energy (P0) and mean radius of each
run, the relative difference reseeded - whole, and that difference over the
standard error of the whole run's mean (z); and, as the scale of ordinary
Monte Carlo noise, the same difference between the whole runs of
consecutive seeds (independent transport streams, the same injection).  The
summary gives, for each, the mean and standard deviation over seeds and the
mean over its standard error (t).

One JSON line per seed, then the summary, also written to ``--out``.  Runs on
the card by default (``--device cpu`` with a few thousand photons for a
rehearsal).  From the repository root: ``python3 tools/resume_reseed.py``.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FRAMES = (3, 4)  # the frames after the resume
KEYS = ("P0", "r")


def run(run_dir, seed, device, n_min, n_max, restart="i", last_frame=None):
    """One ``run_rank`` of the driver configuration in ``run_dir``; its
    WorkAssignment."""
    from mcrat_tpu_torch import Config, Dims, Geometry, SimType
    from mcrat_tpu_torch.driver import default_synthetic_factory, run_rank
    from mcrat_tpu_torch.io.hydro import HydroPaths

    os.makedirs(run_dir, exist_ok=True)
    par = cs.driver_mcpar(os.path.join(run_dir, "mc.par"), 0, n_min, n_max, restart=restart)
    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 simulation_type=SimType.SPHERICAL_OUTFLOW)
    return run_rank(cfg, par, HydroPaths(filepath=run_dir + "/", mc_path="MC/"),
                    synthetic_frame_factory=default_synthetic_factory(cfg, par),
                    generator=torch.Generator().manual_seed(1234 + seed),
                    last_frame_override=last_frame, device=device, output="npz")


def strip_streams(mc_dir):
    """Remove the newest checkpoint and take the stream states out of the
    ``.old`` one left behind (what a JAX-package checkpoint holds)."""
    from mcrat_tpu_torch.io.checkpoint import checkpoint_path

    path = checkpoint_path(mc_dir, 0)
    os.remove(path)
    with np.load(path + ".old") as z:
        kept = {k: z[k] for k in z.files if k not in ("generator_state", "rng_state")}
    with open(path + ".old", "wb") as f:
        np.savez(f, **kept)


def frame_means(mc_dir, frames):
    """frame -> {key: (mean, standard error)} of the merged frames."""
    from mcrat_tpu_torch.io.photons_h5 import merge_all, read_frame

    merge_all(mc_dir, frames)
    out = {}
    for f in frames:
        d = read_frame(os.path.join(mc_dir, f"mcdata_{f}.npz"))
        cols = {"P0": d["P0"], "r": np.sqrt(d["R0"] ** 2 + d["R1"] ** 2 + d["R2"] ** 2)}
        out[f] = {k: (float(v.mean()), float(v.std() / np.sqrt(len(v)))) for k, v in cols.items()}
        out[f]["n"] = len(d["P0"])
    return out


def summary(values):
    v = np.asarray(values, dtype=np.float64)
    sd = float(v.std(ddof=1)) if len(v) > 1 else float("nan")
    return dict(mean=float(v.mean()), sd=sd, t=float(v.mean() / (sd / np.sqrt(len(v)))),
                min=float(v.min()), max=float(v.max()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-min", type=int, default=600_000)
    ap.add_argument("--n-max", type=int, default=1_400_000)
    ap.add_argument("--dir", default=os.path.join(ROOT, "build", "resume_reseed"))
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "resume_reseed.json"))
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"[smi] {smi.stdout.strip()}", flush=True)
        from mcrat_tpu_torch import _build

        _build.build()
    rows, wholes = [], []
    for s in range(args.seeds):
        t0 = time.perf_counter()
        base = os.path.join(args.dir, str(s))
        shutil.rmtree(base, ignore_errors=True)
        whole = run(os.path.join(base, "whole"), s, device, args.n_min, args.n_max)
        cut_dir = os.path.join(base, "reseeded")
        cut = run(cut_dir, s, device, args.n_min, args.n_max, last_frame=2)
        strip_streams(cut.mc_dir)
        run(cut_dir, s, device, args.n_min, args.n_max, restart="c")
        w = frame_means(whole.mc_dir, (2, *FRAMES))
        r = frame_means(cut.mc_dir, (2, *FRAMES))
        row = dict(seed=s, n=w[FRAMES[-1]]["n"], frame2_same=w[2] == r[2],
                   seconds=time.perf_counter() - t0)
        for f in FRAMES:
            for k in KEYS:
                (a, se), (b, _) = w[f][k], r[f][k]
                row[f"{k}_{f}"] = dict(whole=a, reseeded=b, rel=(b - a) / a, z=(b - a) / se)
        rows.append(row)
        wholes.append(w)
        shutil.rmtree(base, ignore_errors=True)
        print(json.dumps(row), flush=True)
    out = {"rows": rows, "reseeded_minus_whole": {}, "independent_streams": {}}
    for f in FRAMES:
        for k in KEYS:
            key = f"{k}_{f}"
            out["reseeded_minus_whole"][key] = {
                "rel": summary([row[key]["rel"] for row in rows]),
                "z": summary([row[key]["z"] for row in rows])}
            # consecutive seeds' whole runs: independent transport streams
            rel = [(b[f][k][0] - a[f][k][0]) / a[f][k][0] for a, b in zip(wholes, wholes[1:])]
            z = [(b[f][k][0] - a[f][k][0]) / a[f][k][1] for a, b in zip(wholes, wholes[1:])]
            out["independent_streams"][key] = {"rel": summary(rel), "z": summary(z)}
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
