"""One run of one cell: set-up, warm-up, the measured window, the traced
sub-windows, and the comparison that decides ``correct``.

The cell's configuration module (``configs/<config>.py``) builds the
program's frame and holds the plain reference and the kernel's least time;
the module of its mix's kind (``kinds/<kind>.py``) makes the population,
runs one window and checks one.  Each window is timed on the host clock
ending in ``torch.cuda.synchronize()``.  Every window checks from the
program's own counters that it ran on the configuration's engine (the
fused-round kernel through its one instantiation, with no launch of the
plain twin).  One window, drawn from the seed by reservoir sampling, is
kept by its generator state and, once the window has closed and the peak
memory is read, run again and held against the plain reference.

``device`` "cpu" runs the same steps on the CPU, where the program's plain
twin stands in for the kernel (the tests' way to drive a whole run).
"""
from __future__ import annotations

import dataclasses
import gc
import random
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import spec as sp
from . import trace as tr
from . import traffic as tf


@dataclasses.dataclass
class Record:
    """What the metric readers read (``metrics/<name>.py``)."""

    spec: dict
    config: object  # the configuration's module (its ``least_time``)
    n_photons: int
    n_cells_held: int
    setup_s: float
    walls: list  # seconds of each measured frame window
    window_s: float  # the measured window, first start to last end
    peak_bytes: int
    trace: Optional[tr.TraceSummary] = None
    trace_n_scatt: Optional[list] = None  # the traced windows' scatterings
    syncs: Optional[int] = None
    sync_windows: int = 0


class PathCheck:
    """Counts the windows that left the configuration's path.  On the
    ``engine`` "kernel" (the default): not the kernel engine, a launch of
    another instantiation than ``instantiation``, a launch of the twin, or
    none of the instantiation; on the CPU the twin is the path.  On "xla":
    not that engine, or any launch of the kernel or the twin."""

    def __init__(self, spec: dict, device: torch.device):
        from mcrat_tpu_torch.ops import fused_round as fr

        self.fr, self.cpu = fr, device.type == "cpu"
        self.engine = spec.get("engine", "kernel")
        self.inst = spec.get("instantiation")
        self.off = 0
        self._snap()

    def _snap(self):
        self.kernel = dict(self.fr.fused_rounds.variant_launches)
        self.twin = self.fr.fused_rounds_reference.launches

    def window(self, res) -> None:
        kernel, twin = dict(self.fr.fused_rounds.variant_launches), \
            self.fr.fused_rounds_reference.launches
        grew = {k: v - self.kernel.get(k, 0) for k, v in kernel.items()
                if v != self.kernel.get(k, 0)}
        if self.engine != "kernel":
            ok = not grew and twin == self.twin
        elif self.cpu:
            ok = not grew and twin > self.twin
        else:
            ok = set(grew) == {self.inst} and twin == self.twin
        self.off += int(res.engine != self.engine or not ok)
        self._snap()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: Optional[float] = None, bench: Optional[dict] = None,
        mix_override: Optional[dict] = None) -> dict:
    """One run of ``workload``.  Returns the result line's dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
    traced, ``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    bench = sp.load_benchmark() if bench is None else bench
    cell = sp.workload(bench, workload)
    spec, config = sp.config(cell["config"])
    mix, kind = sp.mix(cell["traffic"], override=mix_override)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    prob = kind.setup(spec, config, mix, seed, device)
    t_warm = time.perf_counter()
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))

    check = PathCheck(spec, device)

    def window(checked=True):
        res = kind.window(prob, g)
        if checked:
            check.window(res)
        return res

    for _ in range(mix.warmup_windows):
        window()
    _sync(device)
    gc.collect()
    gc.disable()

    # the measured window; one window kept by its generator state, drawn
    # from the seed
    pick = random.Random(tf.host_seed(seed))
    walls, kept, attempted = [], None, 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    phases = (f"setup {setup_s:.3f} s (start {t_build - t_start:.3f}, build {t_warm - t_build:.3f}, "
              f"warm-up {t0 - t_warm:.3f})")
    while True:
        state = g.get_state()
        ta = time.perf_counter()
        res = window(checked=False)
        _sync(device)
        tb = time.perf_counter()
        walls.append(tb - ta)
        check.window(res)
        attempted += 1
        if pick.random() * attempted < 1.0:
            kept = state
        del res
        if tb - t0 >= seconds:
            break
    window_s = tb - t0
    gc.enable()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    rec = Record(spec, config, prob.n_photons, prob.n_cells_held, setup_s, walls, window_s,
                 peak)

    if trace and device.type == "cuda":
        rec.trace, rec.trace_n_scatt = tr.profile(lambda: window().n_scatt, mix.trace_windows)
        rec.syncs = tr.count_syncs(window, mix.sync_windows)
        rec.sync_windows = mix.sync_windows
        peak = rec.peak_bytes = max(peak, torch.cuda.max_memory_allocated())

    # the comparison, after the peak is read; the kind frees the program's
    # state before it runs the reference
    t_ref = time.perf_counter()
    numbers = kind.check(prob, config, kept, seed, device)
    ref_s = time.perf_counter() - t_ref
    del prob, window
    numbers["windows_off_path"] = check.off
    limits = spec["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(numbers[k] <= limits[k] for k in limits)
    failed = check.off + int(not correct and check.off == 0)

    metrics = {}
    for m in sp.metrics_of(bench, workload, trace):
        value = sp.metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(platform="gpu" if device.type == "cuda" else "cpu",
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=int(cell["chips"]), memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=attempted, failed=failed, metrics=metrics,
               device=dev)
    if rec.trace is not None:
        dev.update(busy_s=rec.trace.busy_s, window_s=rec.trace.wall_s)
        out["breakdown"] = dict(device_ops=rec.trace.device_ops, idle_gaps=rec.trace.idle_gaps)
    out["checks"] = checks
    z = " ".join(f"{k} {v:.3f}" for k, v in numbers.get("z", {}).items())
    print(f"[run] {workload} seed {seed}: {phases}; {summary(rec)}; check {ref_s:.3f} s; |z| {z}",
          file=sys.stderr, flush=True)
    return out


def summary(rec: Record) -> str:
    q = np.percentile(np.asarray(rec.walls) * 1e3, [0, 25, 50, 75, 100])
    return (f"{rec.n_photons} photons, {rec.n_cells_held} cells held, "
            f"{len(rec.walls)} windows in {rec.window_s:.3f} s, window ms min/q1/median/q3/max "
            + "/".join(f"{x:.2f}" for x in q))
