"""The readers of the metrics the program's own spans and counters feed
(``mcrat_tpu_torch.telemetry.summary()``): the right values from a summary
made by hand, None from an empty one, and entries in BENCHMARK.json."""
import pytest

from benchmark import spec

FRAMES = 4
SUMMARY = dict(
    frames=FRAMES,
    spans={
        "transport.frame": dict(count=4, host_ms=60.0, self_ms=2.0, stream_ms=50.0),
        "fused_round.call": dict(count=44, host_ms=9.0, self_ms=9.0, stream_ms=8.0),
        "grid.lookup": dict(count=48, host_ms=30.0, self_ms=20.0, stream_ms=26.0),
        "transport.loop_test": dict(count=48, host_ms=1.5, self_ms=1.5, stream_ms=1.0),
        "grid.miss_count": dict(count=48, host_ms=2.5, self_ms=2.5, stream_ms=2.0),
        "transport.fetch": dict(count=4, host_ms=0.4, self_ms=0.4, stream_ms=0.3),
    },
    counters={"transport.kernel_calls": 44, "transport.rows_active": 300,
              "transport.rows_total": 400, "grid.search_lanes": 2000},
)
WANT = {
    "grid.lookup_stream_ms": 26.0 / FRAMES,
    "transport.glue_stream_ms": (50.0 - 8.0) / FRAMES,
    "transport.host_wait_ms": (1.5 + 2.5 + 0.4) / FRAMES,
    "transport.active_row_pct": 75.0,
    "grid.search_lanes_per_frame": 2000 / FRAMES,
}
EMPTY = dict(frames=0, spans={}, counters={})


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_values(name):
    reader = spec.metric_reader(name)
    assert reader.value(SUMMARY) == pytest.approx(WANT[name], rel=1e-12)
    assert reader.value(EMPTY) is None
    assert reader.value(None) is None


def test_no_kernel_call_no_active_rows():
    reader = spec.metric_reader("transport.active_row_pct")
    assert reader.value(dict(SUMMARY, counters={"grid.search_lanes": 2000})) is None


def test_readers_read_nothing_without_a_traced_frame():
    """On the CPU no traced window runs: the program's summary holds no
    frame, and every reader gives None."""
    from mcrat_tpu_torch import telemetry

    telemetry.reset()
    for name in WANT:
        assert spec.metric_reader(name).read(None) is None


def test_entries():
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        m = entries[name]
        assert m["layer"] == "transport glue" and m["moves"] == "photon_frames_per_s"
        assert m["source"] == ("program_counter" if name in (
            "transport.active_row_pct", "grid.search_lanes_per_frame") else "program_span")
    assert entries["grid.search_lanes_per_frame"]["workloads"] == ["amr_jet.frame"]
