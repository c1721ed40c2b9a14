#!/usr/bin/env python3
"""Where the time goes in the port's main frames on one NVIDIA GPU.

Profiles eight frames of ``chip_smoke.py`` through ``transport_frame`` and
the CUDA fused-round kernel (mcrat_tpu_torch), each as chip_smoke.py sets it
up: the DIRECT flagship (160x512 cylindrical outflow, ~1M photons), the 2-D
spherical default frame (384x64 log-r grid), the 3-D cartesian frame (64^3),
the TABLE frame (the flagship grid at T' = 5e8 K, bench.py:265-276), the
nonthermal frame (bench.py:278-294) and the three AMR frames (the flagship
outflow on 167,936 FLASH-block cells, BinnedIndex: DIRECT, TABLE and
nonthermal, the carried path with aux planes); and the driver frame
(``driver``: chip_smoke's driver phase, ``cli run`` of the 2-D spherical
default frame, two injections, frames 0-4, npz dumps).  For each frame,
after one warm-up frame:

  wall_ms              five frames, host clock around a synchronized
                       transport_frame (seeds 1-5);
  select_variant_ms    one call of transport.select_variant (the per-frame
                       set-up: variant, cell table and, in TABLE mode, the
                       Chebyshev rows and nonthermal constants), host clock
                       around it, synchronized before and after;
  kernel_ms            one more frame (seed 7) with a CUDA event pair around
                       every fused_rounds call: per-call times, the host's
                       launch latency included, and their sum
                       (kernel_ms_sum);
  profiled_wall_ms,    one more frame (seed 8) under torch.profiler (CPU +
  device_busy_ms,      CUDA activities): its wall, the sum of the self device
  idle_share           time of every device kernel in it, and
                       idle_share = 1 - device_busy_ms / profiled_wall_ms
                       (device ops do not overlap on the one stream);
  kernel_device_ms,    the self device time of the fused-round kernel's
  kernel_device_calls  launches in that frame, and their number;
  cpu_total_ms         the sum of the self CPU time of every host op;
  top                  the eight device kernels with most self device time.

For the driver, after one warm-up run: one more run under torch.profiler,
its wall (``profiled_wall_ms``, host clock around ``cli run``), the
driver's per-frame ``transport_s``, ``persist_wait_s`` and the writer's
``fetch_s``, ``checkpoint_s`` and ``dump_s`` (its ``frame_timing`` log
records), ``device_busy_ms``, ``idle_share``,
``kernel_device_ms``/``calls`` and ``top`` as above.

Prints one JSON object per frame, and writes them all to ``--out``
(default build/profile_frames.json); ``--frames`` picks some of them.
Needs a CUDA device; imports no JAX.  Run from the repository root:
``python3 tools/profile_torch_frames.py``.
"""
import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402

# frame -> (chip_smoke path, mode, injection seed, T' = 5e8 K)
FRAMES = {"flagship": ("flagship", "direct", 0, False),
          "spherical": ("spherical", "direct", 0, False),
          "cartesian_3d": ("cartesian_3d", "direct", 0, False),
          "table": ("flagship", "table", 2, True),
          "nonthermal": ("flagship", "nt", 3, True),
          "amr": ("amr_cyl2", "direct", 0, False),
          "amr_table": ("amr_cyl2", "aux", 2, True),
          "amr_nonthermal": ("amr_cyl2", "aux_nt", 3, True)}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def synced_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def device_summary(prof, wall_ms) -> dict:
    """Device busy time, idle share, the fused-round kernel's device time
    and calls, host CPU time and the top device kernels of a profile."""
    ka = prof.key_averages()
    dev_ops = [e for e in ka if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ops) / 1e3
    top = sorted(dev_ops, key=lambda e: -e.self_device_time_total)[:8]
    kern = [e for e in dev_ops if "fused_rounds_kernel" in e.key]
    return dict(
        profiled_wall_ms=wall_ms, device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
        kernel_device_ms=sum(e.self_device_time_total for e in kern) / 1e3,
        kernel_device_calls=sum(e.count for e in kern),
        n_device_kernels=sum(e.count for e in dev_ops),
        cpu_total_ms=sum(e.self_cpu_time_total for e in ka
                         if e.device_type != DeviceType.CUDA) / 1e3,
        top=[(e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top],
    )


def profile_driver() -> dict:
    """One warm-up ``cli run`` of chip_smoke's driver phase, then one under
    torch.profiler."""
    dev = torch.device("cuda")
    timings = cs.FrameTimings()
    logging.getLogger("mcrat_tpu_torch").addHandler(timings)
    run_dir = os.path.join(ROOT, "build", "driver_profile")
    for i in range(2):
        shutil.rmtree(run_dir, ignore_errors=True)
        os.makedirs(run_dir)
        mcpar = os.path.join(run_dir, "mc.par")
        cs.driver_mcpar(mcpar, 1, 600_000, 1_400_000)
        timings.rows.clear()
        if i == 0:
            cs.cli_run(run_dir, mcpar, dev)
            continue
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = cs.cli_run(run_dir, mcpar, dev)
    logging.getLogger("mcrat_tpu_torch").removeHandler(timings)
    return dict(frames=len(timings.rows), n_photons=[t["n_photons"] for t in timings.rows],
                transport_s=[t["transport_s"] for t in timings.rows],
                persist_wait_s=[t["persist_wait_s"] for t in timings.rows],
                **{k: [t[k] for t in timings.rows] for k in ("fetch_s", "checkpoint_s", "dump_s")},
                **device_summary(prof, 1e3 * wall))


def profile_frame(prob) -> dict:
    from mcrat_tpu_torch import transport
    from mcrat_tpu_torch.ops import fused_round as fr

    cs.run_frame(prob, 0, fr.fused_rounds, dt_max=prob.dt_max)  # warm-up
    walls = [synced_ms(lambda s=s: cs.run_frame(prob, s, fr.fused_rounds, dt_max=prob.dt_max))
             for s in range(1, 6)]
    setup_ms = synced_ms(lambda: transport.select_variant(prob.cfg, prob.frame, prob.index,
                                                          prob.xsec))

    events = []

    def timed_rounds(*args, **kwargs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fr.fused_rounds(*args, **kwargs)
        e1.record()
        events.append((e0, e1))
        return out

    res = cs.run_frame(prob, 7, timed_rounds, dt_max=prob.dt_max)
    torch.cuda.synchronize()
    kms = [a.elapsed_time(b) for a, b in events]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pwall = synced_ms(lambda: cs.run_frame(prob, 8, fr.fused_rounds, dt_max=prob.dt_max))
    return dict(
        n_photons=prob.photons.capacity, n_rounds=res.n_rounds, n_scatt=res.n_scatt,
        wall_ms=walls, select_variant_ms=setup_ms, kernel_calls=len(kms),
        kernel_ms_sum=sum(kms), kernel_ms=kms, **device_summary(prof, pwall),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile_frames.json"))
    ap.add_argument("--frames", nargs="+", default=[*FRAMES, "driver"],
                    choices=[*FRAMES, "driver"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from mcrat_tpu_torch import Config

    dev = torch.device("cuda")
    print(f"[smi] {smi()}", flush=True)
    tables = cs.xsec_tables(Config(), dev)
    out = {}
    for frame in args.frames:
        if frame == "driver":
            out[frame] = profile_driver()
        else:
            path, mode, seed, hot = FRAMES[frame]
            prob = cs.problem(path, dev, 600_000, 1_400_000, seed=seed, hot=hot, mode=mode,
                              tables=tables)
            out[frame] = profile_frame(prob)
            del prob
        print(json.dumps({"frame": frame, **out[frame]}), flush=True)
    print(f"[smi] {smi()}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
