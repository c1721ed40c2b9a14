"""What a traced run reads: device activity from ``torch.profiler`` and the
host-device synchronizations from torch's sync debug mode.

The profiler's chrome trace gives every device activity (kernels, copies,
sets) and every host operation with start and duration on one clock.  The
device is busy in the union of its activities' intervals: adding up kernel
times holds only on one stream.  An idle gap between busy intervals is put
down to the innermost host operation running at its middle.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
import time
import warnings

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
FUSED_KERNEL = "fused_rounds_kernel"
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    windows: int  # frame windows traced
    wall_s: float  # host clock over them, ending in a synchronize
    busy_s: float  # union of the device's busy intervals
    fused_kernels: int  # launches of the fused-round kernel
    fused_s: float  # their device time
    other_kernels: int  # every other kernel launched
    device_ops: list  # [[name, seconds], ...], the most device time first
    idle_gaps: list  # [[host operation, seconds], ...], the longest first


def _short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list, windows: int, wall_s: float) -> TraceSummary:
    """A summary of chrome-trace events (``ph`` "X", times in us)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS))
    busy = _merge([(e["ts"], e["ts"] + e.get("dur", 0)) for e in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name = collections.Counter()
    fused_n = other_n = 0
    fused_us = 0.0
    for e in dev:
        by_name[_short(e["name"])] += e.get("dur", 0)
        if e["cat"] == "kernel":
            if FUSED_KERNEL in e["name"]:
                fused_n += 1
                fused_us += e.get("dur", 0)
            else:
                other_n += 1
    starts = [h[0] for h in host]
    gaps = collections.Counter()
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + nxt)
        at = bisect.bisect_right(starts, mid)
        # the innermost host operation holding the gap's middle (the latest
        # started one that has not ended), else the one the host starts next
        label = "between operations, before " + (_short(host[at][2]) if at < len(host)
                                                 else "the end")
        for a, b, name in reversed(host[max(0, at - 64):at]):
            if a <= mid <= b:
                label = _short(name)
                break
        gaps[label] += nxt - end
    return TraceSummary(
        windows=windows, wall_s=wall_s, busy_s=busy_us * 1e-6, fused_kernels=fused_n,
        fused_s=fused_us * 1e-6, other_kernels=other_n,
        device_ops=[[n, us * 1e-6] for n, us in by_name.most_common(TOP)],
        idle_gaps=[[n, us * 1e-6] for n, us in gaps.most_common(TOP)])


def profile(window, n: int):
    """(summary, what each call returned): ``n`` calls of ``window()`` under
    ``torch.profiler`` (CPU and CUDA activity), the chrome trace read back
    from a temporary file and deleted."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    results = []
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            results.append(window())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, n, wall), results


def count_syncs(window, n: int) -> int:
    """Host-device synchronizations in ``n`` calls of ``window()``: torch's
    sync debug mode warns at each."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                window()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)
