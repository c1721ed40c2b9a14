"""The program's spans on the benchmark's cells (``mcrat_tpu_torch.telemetry``).

    python3 tools/frame_spans.py --out build/frame_spans.json [--cells ...] [--pairs 12]
    python3 tools/frame_spans.py --cpu-span      # the cost of a span with tracing off

For each cell, on one population made as the benchmark makes it
(``benchmark/kinds``, the cell's seed): warm-up windows, then ``--pairs``
pairs of frame windows in turns, one with tracing off and one with
``telemetry.enable()`` (no profiler), each timed on the host clock ending in
a synchronize: the median window of each, and the spans and counters of the
traced ones a frame (host, self and stream ms; counts).  Then the mix's
traced windows under ``torch.profiler`` (``benchmark/trace.py``), with the
spans the profiler turns on: the kernel's device time in the profiler's
trace against the ``fused_round.call`` spans' event clock, the share of
``transport.frame``'s host time its child spans cover, and the benchmark's
readers of the spans.  Prints one JSON line a cell and writes them all to
``--out``.  ``--device cpu`` with small ``--photons`` rehearses it on the
CPU, through the kernel's twin and without the profiler.
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELLS = ("cyl2_jet.frame_small", "cyl2_jet.frame", "amr_jet.frame")
READERS = ("grid.lookup_stream_ms", "transport.glue_stream_ms", "transport.host_wait_ms",
           "transport.active_row_pct", "grid.search_lanes_per_frame")


def span_cost(n: int = 200_000, repeats: int = 7) -> dict:
    """Microseconds of one ``with span(name): pass`` and of one ``count``
    with tracing off, less the bare loop's (the best of ``repeats``)."""
    from mcrat_tpu_torch import telemetry

    span, count = telemetry.span, telemetry.count
    assert not telemetry._on

    def best(body):
        out = []
        for _ in range(repeats):
            t = time.perf_counter()
            body()
            out.append(time.perf_counter() - t)
        return min(out) / n * 1e6

    def bare():
        for _ in range(n):
            pass

    def spans():
        for _ in range(n):
            with span("grid.lookup"):
                pass

    def counts():
        for _ in range(n):
            count("grid.search_lanes", 7)

    loop = best(bare)
    return dict(loop_us=loop, span_us=best(spans) - loop, count_us=best(counts) - loop)


def span_costs(n: int = 5000, repeats: int = 5) -> dict:
    """Microseconds of the pieces of a span on the card, with no profiler
    and under one: a span with tracing on (events or not), the profiler
    annotation, a CUDA event's record, the current stream and device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcrat_tpu_torch import telemetry

    ev = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream()
    done = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    done.record(stream)
    done.synchronize()

    def create():
        torch.cuda.Event(enable_timing=True).record(stream)

    def resolve():
        done.query()
        ev.elapsed_time(done)
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)

    def loop(body):
        def run():
            for _ in range(n):
                body()
        return run

    def with_span(events):
        def body():
            telemetry._on, telemetry._cuda = True, events
            telemetry._annotate = telemetry._profiling()
            try:
                with telemetry.span("grid.lookup"):
                    pass
            finally:
                telemetry._on = telemetry._cuda = telemetry._annotate = False
        return body

    def annotate(cm):
        def body():
            with cm("grid.lookup"):
                pass
        return body

    pieces = dict(
        span_off=lambda: telemetry.span("grid.lookup").__enter__(),
        span_on_host=with_span(False), span_on_events=with_span(True),
        record_function=annotate(telemetry.record_function),
        annotation=annotate(telemetry._Annotation),
        event_record=ev.record, event_record_stream=lambda: ev.record(stream),
        current_stream=torch.cuda.current_stream, current_device=torch.cuda.current_device,
        event_create_record=create, event_resolve=resolve)
    if fast is not None:
        pieces["record_function_fast"] = annotate(fast)

    def measure():
        out = {}
        for name, body in pieces.items():
            best = []
            for _ in range(repeats):
                torch.cuda.synchronize()
                t = time.perf_counter()
                loop(body)()
                best.append(time.perf_counter() - t)
                telemetry.reset()
            out[name] = min(best) / n * 1e6
        return out

    plain = measure()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        profiled = measure()
    torch.cuda.synchronize()
    return dict(no_profiler=plain, profiler=profiled)


def profiled_turns(kind, prob, g, turns: int) -> dict:
    """Median milliseconds of a frame window under one ``torch.profiler``
    session, in turns: with the spans off (as a program without them
    runs), on with the event pool warm, and on with it emptied first (every
    CUDA event made anew)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcrat_tpu_torch import telemetry

    real = telemetry._profiling
    walls = {"off": [], "warm": [], "cold": []}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for i in range(turns):
            for mode in ("off", "warm", "cold")[::1 if i % 2 == 0 else -1]:
                telemetry.reset()
                if mode == "cold":
                    telemetry._pool.clear()
                telemetry._profiling = (lambda: False) if mode == "off" else real
                try:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    kind.window(prob, g)
                    torch.cuda.synchronize()
                    walls[mode].append((time.perf_counter() - t) * 1e3)
                finally:
                    telemetry._profiling = real
    telemetry.reset()
    return {k: dict(median_ms=statistics.median(v), walls_ms=v) for k, v in walls.items()}


def per_frame(summaries: list) -> dict:
    """Summaries of ``telemetry.summary()`` added up, a frame: each span's
    count, host, self and stream ms and each counter over the frames."""
    frames = sum(s["frames"] for s in summaries) or 1
    spans, counters = {}, {}
    for s in summaries:
        for name, v in s["spans"].items():
            acc = spans.setdefault(name, dict(count=0.0, host_ms=0.0, self_ms=0.0,
                                              stream_ms=None))
            for k in ("count", "host_ms", "self_ms"):
                acc[k] += v[k] / frames
            if v["stream_ms"] is not None:
                acc["stream_ms"] = (acc["stream_ms"] or 0.0) + v["stream_ms"] / frames
        for name, v in s["counters"].items():
            counters[name] = counters.get(name, 0.0) + v / frames
    return dict(frames=frames, spans=spans, counters=counters,
                spans_per_frame=sum(v["count"] for v in spans.values()))


def cell_run(cell: str, seed: int, pairs: int, device, photons=None) -> dict:
    import torch

    from benchmark import spec as sp
    from benchmark import trace as tr
    from mcrat_tpu_torch import telemetry

    bench = sp.load_benchmark()
    spec, config = sp.config(sp.workload(bench, cell)["config"])
    override = dict(min_photons=photons[0], max_photons=photons[1]) if photons else None
    mix, kind = sp.mix(sp.workload(bench, cell)["traffic"], override=override)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    prob = kind.setup(spec, config, mix, seed, device)
    g = torch.Generator().manual_seed(seed)
    for _ in range(mix.warmup_windows):
        kind.window(prob, g)
    sync()
    walls = {False: [], True: []}
    summaries = []
    for i in range(2 * pairs):
        on = (i % 2 == 1) == (i // 2 % 2 == 0)  # off, on, on, off, ...
        telemetry.reset()
        telemetry.enable(on)
        sync()
        t = time.perf_counter()
        kind.window(prob, g)
        sync()
        walls[on].append(time.perf_counter() - t)
        telemetry.enable(False)
        if on:
            summaries.append(telemetry.summary())
    telemetry.reset()
    med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    out = dict(cell=cell, seed=seed, n_photons=prob.n_photons, pairs=pairs,
               window_ms_off=med[False], window_ms_on=med[True],
               tracing_cost_pct=100.0 * (med[True] / med[False] - 1.0),
               walls_ms_off=[w * 1e3 for w in walls[False]],
               walls_ms_on=[w * 1e3 for w in walls[True]],
               enabled=per_frame(summaries))
    if cuda:
        out["device"] = torch.cuda.get_device_name(device)
        trace, _ = tr.profile(lambda: kind.window(prob, g).n_scatt, mix.trace_windows)
        # spans whose events are still unread, and the events made, before summary() waits
        pending = len(telemetry._pending)
        events = sum(len(v) for v in telemetry._pool.values()) + 2 * pending
        summ = telemetry.summary()
        frame = per_frame([summ])
        spans = frame["spans"]
        fused_ms = spans.get("fused_round.call", {}).get("stream_ms")
        out["profiled"] = dict(
            windows=trace.windows, window_ms=trace.wall_s * 1e3 / trace.windows,
            kernel_ms=trace.fused_s * 1e3 / trace.windows, fused_call_stream_ms=fused_ms,
            frame_children_share=1.0 - spans["transport.frame"]["self_ms"]
            / spans["transport.frame"]["host_ms"],
            other_kernels=trace.other_kernels / trace.windows, idle_gaps=trace.idle_gaps,
            pending_spans=pending, events_made=events,
            readers={name: sp.metric_reader(name).value(summ) for name in READERS},
            spans=frame)
        out["profiled_turns"] = profiled_turns(kind, prob, g, max(3, pairs // 2))
        telemetry.reset()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="*", default=list(CELLS))
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--photons", type=int, nargs=2, default=None,
                    help="the population's bounds (a small rehearsal on the CPU)")
    ap.add_argument("--cpu-span", action="store_true",
                    help="only the cost of a span and a count with tracing off")
    ap.add_argument("--span-costs", action="store_true",
                    help="first, the pieces of a span on the card, timed alone")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    results = [dict(cpu_span=span_cost())]
    print(json.dumps(results[0]), flush=True)
    if args.span_costs:
        results.append(dict(span_costs=span_costs()))
        print(json.dumps(results[-1]), flush=True)
    if not args.cpu_span:
        device = torch.device(args.device)
        for cell in args.cells:
            res = cell_run(cell, args.seed, args.pairs, device, args.photons)
            results.append(res)
            print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
