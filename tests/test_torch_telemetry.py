"""Spans and counters inside the frame loop (``mcrat_tpu_torch.telemetry``),
on the CPU through the kernel's plain twin.

* Tracing off: nothing is recorded, ``span()`` is one shared object, a
  frame reads the clock only at its scope's ends, and spans and counters
  open no annotation or event and keep nothing.
* ``enable()``: a small direct frame (the cylindrical outflow on a uniform
  grid) and a small carried frame (the same outflow as FLASH AMR blocks)
  record the span tree of the frame loop with the right parents; the
  counters agree with the twin's launches and the spans; each frame's
  result is bit-identical with tracing on and off.
* A TABLE frame records the per-frame fit of ``select_variant`` once a
  frame (``hot_xsec.cheb_cells``) and, with nonthermal electrons, its
  constants (``hot_xsec.nt_constants``); a DIRECT frame records neither.
  A chunked frame fetches its grid scalars once, in its setup.
* A recording ``torch.profiler`` turns tracing on with no ``enable()``, and
  the span names appear among its events.
* A 2-shard CPU mesh frame records its frame and chunk spans; a one-shard
  mesh frame records its setup inside its frame, as ``transport_frame``.
* The driver's frames nest the transport frames; ``cli run --trace-json``
  writes them; ``timed`` feeds its sink whether tracing is on or not.
"""
import dataclasses
import itertools
import json
import logging
import tracemalloc

import numpy as np
import pytest
import torch

from mcrat_tpu_torch import (Config, Dims, Geometry, NonthermalDist, SimType, Spectrum,
                             TauCalculation, grid, telemetry)
from mcrat_tpu_torch import transport as tt
from mcrat_tpu_torch.io.flash import cells_from_blocks
from mcrat_tpu_torch.models.analytic import amr_blocks_2d, cylindrical_prep, make_grid_2d
from mcrat_tpu_torch.ops import fused_round as fr
from mcrat_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

CFG = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
             simulation_type=SimType.CYLINDRICAL_OUTFLOW)
BAND = (1.8e12, 2.9e12)
S_ROWS = 8
CHUNK = 16

# (span, the span it opens inside) of every frame of the kernel path
TREE = {
    ("transport.frame", None),
    ("transport.select_variant", "transport.frame"),
    ("transport.step", "transport.frame"),
    ("transport.fetch", "transport.frame"),
    ("transport.compact", "transport.frame"),
    ("transport.write_back", "transport.frame"),
    ("transport.lane_planes", "transport.step"),
    ("transport.loop_test", "transport.step"),
    ("transport.partition", "transport.step"),
    ("grid.lookup", "transport.step"),
    ("fused_round.call", "transport.step"),
    ("transport.unplane", "transport.step"),
}
CARRIED = {("grid.miss_count", "grid.lookup"), ("grid.search", "grid.lookup")}


def _host(kind):
    if kind == "direct":
        edges = (np.linspace(0.0, 3.2e11, 41), np.linspace(*BAND, 129))
        host = grid.frame_from_numpy(CFG, make_grid_2d(CFG, *edges))
        index = grid.build_rectilinear_index(*edges, device="cpu")
    else:
        coords, size = amr_blocks_2d([(0.0, 1.28e11, 4, 32), (1.28e11, 3.2e11, 2, 16)], *BAND)
        ones = np.ones((len(coords), 64))
        host = cells_from_blocks(CFG, coords, size,
                                 dict(velx=0 * ones, vely=0 * ones, dens=ones, pres=ones))
        index = None
    cylindrical_prep(host)
    if index is None:
        index = grid.build_binned_index(host, device="cpu")
    return host, index


@pytest.fixture(scope="module")
def problems():
    out = {}
    for kind in ("direct", "carried"):
        host, index = _host(kind)
        arrays, _ = tt.inject_photons(host, 2e12, 1e50, 1500, 3000, Spectrum.BLACKBODY, 0.0,
                                      0.1047, 5.0, np.random.default_rng(3))
        photons, _ = tt.photons_from_arrays(arrays, device="cpu")
        out[kind] = (host.to_device("cpu"), index, photons)
    return out


def _frame(problems, kind, seed=5):
    frame, index, photons = problems[kind]
    return tt.transport_frame(CFG, photons, frame, index, 0.2,
                              torch.Generator().manual_seed(seed), chunk_rounds=CHUNK,
                              fused=True, s_rows=S_ROWS)


@pytest.fixture
def tracing():
    telemetry.reset()
    telemetry.enable(False)
    yield telemetry
    telemetry.enable(False)
    telemetry.reset()


def _tree(snapshot):
    names = {r["id"]: r["name"] for r in snapshot}
    return {(r["name"], names.get(r["parent"])) for r in snapshot}


def test_tracing_off_records_nothing(problems, tracing):
    assert telemetry.span("grid.lookup") is telemetry.span("transport.frame")
    before = fr.fused_rounds_reference.launches
    _frame(problems, "carried")
    assert fr.fused_rounds_reference.launches > before
    assert telemetry.snapshot() == []
    assert telemetry.summary() == dict(frames=0, spans={}, counters={})


def test_tracing_off_reads_no_clock_and_annotates_nothing(problems, tracing, monkeypatch):
    """A frame with tracing off reads the host clock only at its scope's
    start and end, however many spans it runs, and opens no profiler
    annotation and no CUDA event."""
    reads = []
    real = telemetry.time.perf_counter_ns

    class Clock:
        @staticmethod
        def perf_counter_ns():
            reads.append(1)
            return real()

    def refuse(*args, **kwargs):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(telemetry, "time", Clock)
    monkeypatch.setattr(telemetry, "_Annotation", refuse)
    monkeypatch.setattr(telemetry, "_take_events", refuse)
    _frame(problems, "carried")
    assert len(reads) == 2


def test_tracing_off_keeps_nothing(tracing):
    span, count = telemetry.span, telemetry.count

    def calls(n):
        for _ in range(n):
            with span("grid.lookup"):
                count("grid.search_lanes", 7)

    calls(100)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        calls(10000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    # nothing that the module allocated is kept (other threads of the test
    # process, such as a test runner's, may allocate meanwhile: not counted)
    only = [tracemalloc.Filter(True, telemetry.__file__)]
    grown = after.filter_traces(only).compare_to(before.filter_traces(only), "lineno")
    assert [st for st in grown if st.size_diff > 0 or st.count_diff > 0] == []


@pytest.fixture(scope="module")
def nt_tables():
    from mcrat_tpu_torch.ops import hot_xsec

    return hot_xsec.load_or_build(HOT_CFG["nonthermal"], None, device="cpu")


HOT_CFG = dict(
    direct=CFG,
    table=dataclasses.replace(CFG, tau_calculation=TauCalculation.TABLE),
    nonthermal=dataclasses.replace(CFG, tau_calculation=TauCalculation.TABLE,
                                   nonthermal_e_dist=NonthermalDist.POWERLAW,
                                   powerlaw_index=2.5, gamma_min=1.0, gamma_max=100.0))


@pytest.mark.parametrize("mode", ["direct", "table", "nonthermal"])
def test_hot_xsec_fit_spans(problems, tracing, nt_tables, mode):
    frame, index, photons = problems["direct"]
    telemetry.enable()
    for seed in (5, 6):
        tt.transport_frame(HOT_CFG[mode], photons, frame, index, 0.2,
                           torch.Generator().manual_seed(seed), chunk_rounds=CHUNK, fused=True,
                           s_rows=S_ROWS, xsec_table=None if mode == "direct" else nt_tables)
    summ = telemetry.summary()
    spans = summ["spans"]
    assert summ["frames"] == 2
    fit = {"direct": 0, "table": 2, "nonthermal": 2}[mode]
    assert spans.get("hot_xsec.cheb_cells", {}).get("count", 0) == fit
    assert spans.get("hot_xsec.nt_constants", {}).get("count", 0) == 2 * (mode == "nonthermal")


@pytest.mark.parametrize("kind", ["direct", "carried"])
def test_span_tree_and_counters(problems, tracing, kind):
    telemetry.enable(records=True)
    before = fr.fused_rounds_reference.launches
    res = _frame(problems, kind)
    calls = fr.fused_rounds_reference.launches - before
    snap = telemetry.snapshot()
    summ = telemetry.summary()
    want = TREE | (CARRIED if kind == "carried" else set())
    assert _tree(snap) == want
    assert summ["frames"] == 1 and {r["frame"] for r in snap} == {0}
    c, spans = summ["counters"], summ["spans"]
    assert c["transport.kernel_calls"] == calls == spans["fused_round.call"]["count"] > 1
    assert 0 < c["transport.rows_active"] < c["transport.rows_total"]
    assert spans["transport.partition"]["count"] >= 1
    assert spans["transport.compact"]["count"] >= 1
    steps = spans["transport.step"]["count"]
    assert steps == spans["transport.fetch"]["count"] > 1
    assert spans["grid.lookup"]["count"] == calls + steps
    assert spans["transport.unplane"]["count"] == 2 * steps
    assert res.n_rounds > 0
    if kind == "direct":
        assert c.get("grid.search_lanes", 0) == 0
    else:
        assert c["grid.search_lanes"] > 0 and spans["grid.search"]["count"] >= 1
    # host times: each span holds its children; no device time on the CPU
    for s in spans.values():
        assert s["stream_ms"] is None and 0.0 <= s["self_ms"] <= s["host_ms"]
    by_id = {r["id"]: r for r in snap}
    for r in snap:
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]


@pytest.mark.parametrize("kind", ["direct", "carried"])
def test_result_bit_identical_with_tracing_on_and_off(problems, tracing, kind):
    off = _frame(problems, kind, seed=11)
    telemetry.enable()
    on = _frame(problems, kind, seed=11)
    assert telemetry.summary()["frames"] == 1
    assert (on.n_scatt, on.n_rounds, on.engine) == (off.n_scatt, off.n_rounds, off.engine)
    assert torch.equal(on.t_rem, off.t_rem)
    for k, v in off.photons.fields().items():
        assert torch.equal(getattr(on.photons, k), v), k


def test_search_lanes_count_the_lanes_that_left_their_cell(problems, tracing, monkeypatch):
    """A carried frame's ``grid.search_lanes`` are the lanes its lookups
    searched (the plain search's lanes here; on the card the kernel's
    device counter), carried in each chunk's one fetch; ``grid.lookup_lanes``
    the lanes of every lookup, the chunk's last included."""
    searched, looked_up = [], []
    find, lookup = grid.BinnedIndex.find, grid.find_cell_rows_reference

    def spy_find(self, r0, *rest):
        searched.append(r0.shape[0])
        return find(self, r0, *rest)

    def spy_lookup(cfg, index, frame, pos, *rest, **kw):
        looked_up.append(pos.shape[0])
        return lookup(cfg, index, frame, pos, *rest, **kw)

    monkeypatch.setattr(grid.BinnedIndex, "find", spy_find)
    monkeypatch.setattr(grid, "find_cell_rows_reference", spy_lookup)
    telemetry.enable()
    _frame(problems, "carried")
    summ = telemetry.summary()
    c, spans = summ["counters"], summ["spans"]
    assert c["grid.search_lanes"] == sum(searched) > 0
    assert len(searched) == spans["grid.search"]["count"]
    assert len(looked_up) == spans["grid.lookup"]["count"]
    assert c["grid.lookup_lanes"] == sum(looked_up) > sum(searched)


@pytest.mark.parametrize("records", [False, True])
def test_enable_keeps_totals_and_records_only_on_request(problems, tracing, records):
    """``enable()`` keeps running totals by span name; the records of the
    spans only with ``records=True``, and the totals are the same."""
    telemetry.enable(records=records)
    _frame(problems, "carried")
    summ = telemetry.summary()
    snap = telemetry.snapshot()
    assert summ["frames"] == 1
    if not records:
        assert snap == []
        return
    counts = {}
    for r in snap:
        counts[r["name"]] = counts.get(r["name"], 0) + 1
    assert counts == {name: s["count"] for name, s in summ["spans"].items()}
    for name, s in summ["spans"].items():
        host = sum(r["host_ms"] for r in snap if r["name"] == name)
        assert s["host_ms"] == pytest.approx(host, rel=1e-9, abs=1e-9)


class _Event:
    """A CUDA timing event's stand-in: the device passes it when the test
    says so; ``synchronize`` is a wait, and is counted."""

    clock = itertools.count()
    waits = 0

    def record(self, stream=None):
        self.t, self.done = next(_Event.clock), False

    def query(self):
        return self.done

    def synchronize(self):
        _Event.waits += 1
        self.done = True

    def elapsed_time(self, end):
        assert end.done  # and so the start event, recorded before it on the stream
        return float(end.t - self.t)


def test_traced_frames_on_a_card_give_their_events_back(tracing, monkeypatch):
    """A traced frame on a card reads, at its entry, the events of the spans
    the device has passed, with no wait, and gives them back to the pool:
    over many frames the spans pending and the events in use stay at one
    frame's, and only ``summary()`` waits, for what the device has not
    passed yet."""
    made = []

    def take():
        free = telemetry._pool.setdefault(0, [])
        if len(free) < 2:
            made.extend((_Event(), _Event()))
            free.extend(made[-2:])
        return 0, free.pop(), free.pop(), None

    monkeypatch.setattr(telemetry, "_take_events", take)
    telemetry.enable()
    _Event.waits = 0
    per_frame = 1 + 3 * 2
    for _ in range(40):
        with telemetry.frame(telemetry.FRAME, "cuda"):
            for _ in range(3):
                with telemetry.span("transport.step"):
                    with telemetry.span("grid.lookup"):
                        pass
        assert len(telemetry._pending) == per_frame
        for e in made:  # the device catches up
            if hasattr(e, "done"):
                e.done = True
    assert len(made) == 2 * per_frame and _Event.waits == 0
    with telemetry.frame(telemetry.FRAME, "cuda"):
        pass
    assert len(telemetry._pending) == 1
    summ = telemetry.summary()
    assert _Event.waits == 1 and telemetry._pending == []
    assert len(telemetry._pool[0]) == len(made)
    spans = summ["spans"]
    assert summ["frames"] == 41 and spans["grid.lookup"]["count"] == 120
    assert spans["transport.frame"]["stream_ms"] > spans["transport.step"]["stream_ms"] > \
        spans["grid.lookup"]["stream_ms"] > 0


def test_a_recording_profiler_turns_tracing_on(problems, tracing):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame(problems, "direct")
    summ = telemetry.summary()
    assert summ["frames"] == 1 and summ["counters"]["transport.kernel_calls"] > 1
    names = {e.name for e in prof.events()}
    assert {n for n, _ in TREE} <= names
    _frame(problems, "direct")  # no profiler now: nothing more recorded
    assert telemetry.summary()["frames"] == 1


def test_mesh_frame_records_frame_and_steps(problems, tracing):
    frame, index, photons = problems["direct"]
    mesh = pm.make_mesh(devices=["cpu"] * 2)
    telemetry.enable(records=True)
    res = pm.sharded_transport_frame(CFG, mesh, pm.spread_photons(photons, mesh), frame, index,
                                     0.2, torch.Generator().manual_seed(5),
                                     chunk_rounds=CHUNK, fused=True, s_rows=S_ROWS)
    assert res.n_rounds > 0
    summ = telemetry.summary()
    tree = _tree(telemetry.snapshot())
    assert summ["frames"] == 1
    assert {("transport.step", "transport.frame"), ("transport.fetch", "transport.frame"),
            ("fused_round.call", "transport.step")} <= tree
    # both shards' kernel calls, each under the chunk's step
    assert summ["spans"]["transport.lane_planes"]["count"] == 2 * summ["spans"][
        "transport.step"]["count"]


def test_one_shard_mesh_frame_records_its_setup_in_its_frame(problems, tracing, nt_tables):
    """The setup of a TABLE frame (``transport.select_variant`` and its fit,
    ``hot_xsec.cheb_cells``) is recorded inside the frame, on a one-shard
    mesh as in ``transport_frame``."""
    frame, index, photons = problems["direct"]
    cfg = HOT_CFG["table"]
    kw = dict(chunk_rounds=CHUNK, fused=True, s_rows=S_ROWS, xsec_table=nt_tables)
    want = {("transport.select_variant", "transport.frame"),
            ("hot_xsec.cheb_cells", "transport.select_variant")}
    telemetry.enable(records=True)
    tt.transport_frame(cfg, photons, frame, index, 0.2, torch.Generator().manual_seed(5), **kw)
    assert want <= _tree(telemetry.snapshot())
    telemetry.reset()
    pm.sharded_transport_frame(cfg, pm.make_mesh(devices=["cpu"]), photons, frame, index, 0.2,
                               torch.Generator().manual_seed(5), **kw)
    assert want <= _tree(telemetry.snapshot())
    assert telemetry.summary()["spans"]["hot_xsec.cheb_cells"]["count"] == 1


def test_chunked_frame_fetches_grid_scalars_once(problems, tracing, monkeypatch):
    """A carried frame of several chunks reads the kernel's grid scalars
    (one host fetch) once, in its setup, not once a chunk."""
    calls = []
    real = tt.grid_scalars
    monkeypatch.setattr(tt, "grid_scalars", lambda *a: calls.append(a) or real(*a))
    telemetry.enable()
    _frame(problems, "carried")
    assert telemetry.summary()["spans"]["transport.step"]["count"] >= 2
    assert len(calls) == 1


def test_summary_self_time_frames_and_timed_sinks(tracing):
    sink = {}
    with telemetry.timed("driver.persist.dump", sink, "dump_s") as t:
        pass
    assert sink["dump_s"] == t.seconds >= 0.0 and telemetry.snapshot() == []
    telemetry.enable(records=True)
    with telemetry.frame("driver.frame", "cpu") as outer:
        with telemetry.frame(telemetry.FRAME, "cpu"):
            with telemetry.span("transport.step"):
                with telemetry.span("grid.lookup"):
                    telemetry.count("grid.search_lanes", 3)
            telemetry.count("grid.search_lanes", 4)
        with telemetry.timed("driver.persist.dump", sink, "dump_s"):
            pass
        assert outer.elapsed_s() >= 0.0
    assert sink["dump_s"] >= t.seconds
    telemetry.enable(False)
    with telemetry.frame(telemetry.FRAME, "cpu"):
        with telemetry.span("transport.step"):
            telemetry.count("grid.search_lanes", 100)
    summ = telemetry.summary()
    assert summ["frames"] == 1 and summ["counters"] == {"grid.search_lanes": 7}
    s = summ["spans"]
    assert set(s) == {"driver.frame", "transport.frame", "transport.step", "grid.lookup",
                      "driver.persist.dump"}
    assert all(v["count"] == 1 for v in s.values())
    for name, child in (("transport.step", "grid.lookup"),
                        ("transport.frame", "transport.step")):
        assert s[name]["self_ms"] == pytest.approx(s[name]["host_ms"] - s[child]["host_ms"],
                                                   abs=1e-9)
    snap = {r["name"]: r for r in telemetry.snapshot()}
    assert snap["driver.frame"]["frame"] is None and snap["grid.lookup"]["frame"] == 0
    assert snap["transport.frame"]["parent"] == snap["driver.frame"]["id"]
    telemetry.reset()
    assert telemetry.summary() == dict(frames=0, spans={}, counters={})


def test_cli_trace_json_nests_transport_frames_in_driver_frames(tmp_path, tracing, caplog):
    from mcrat_tpu_torch import cli, convert
    from mcrat_tpu_torch.io import mcpar as tmcpar

    from test_driver import _par

    par = dataclasses.replace(convert.mcpar_from_reference(_par()), n_theta_bins=1,
                              frm0=(10,), frm2=(10,), inj_radius=(8e12,))
    mcpar = str(tmp_path / "mc.par")
    tmcpar.write_mcpar(par, mcpar)
    path = tmp_path / "trace.json"
    with caplog.at_level(logging.INFO, logger="mcrat_tpu_torch"):
        assert cli.main(["run", "--mcpar", mcpar, "--filepath", str(tmp_path) + "/", "--sim",
                         "synthetic", "--geometry", "spherical", "--dims", "2",
                         "--simulation-type", "spherical_outflow", "--chunk-rounds", "0",
                         "--synthetic-grid", "128", "24", "--last-frame", "11", "--device",
                         "cpu", "--output", "npz", "--trace-json", str(path)]) == 0
    assert not telemetry._enabled  # the run's end turns tracing off again
    timings = [r.frame_timing for r in caplog.records if hasattr(r, "frame_timing")]
    data = json.loads(path.read_text())
    spans, summ = data["spans"], data["summary"]
    by_id = {r["id"]: r for r in spans}
    frames = [r for r in spans if r["name"] == "driver.frame"]
    assert len(frames) == len(timings) == 2
    transport = [r for r in spans if r["name"] == "transport.frame"]
    assert summ["frames"] == len(transport) == 2
    assert all(by_id[r["parent"]]["name"] == "driver.frame" for r in transport)
    for name in ("driver.persist.fetch", "driver.persist.checkpoint", "driver.persist.dump"):
        assert summ["spans"][name]["count"] == 2
    for t, f in zip(timings, frames):
        assert 0.0 <= t["transport_s"] <= f["host_ms"] * 1e-3
