"""The hot, nonthermal FLASH jet cell, ``amr_table.frame``: it finds its
configuration, mix, kind and reference by name, reports the four
end-to-end metrics and its own five per-layer metrics, its least time
matches a hand count, and its readers read what the program records (and
nothing from a program without the ``transport.aux_lanes`` counter or the
``transport.aux_planes`` span)."""
import types

import pytest

from benchmark import roofline, spec
from benchmark.reference import amr_table

CELL = "amr_table.frame"
OWN = {"fused_round_aux.kernel_ms", "fused_round_aux_roofline",
       "transport.aux_planes_stream_ms", "transport.aux_lanes_per_frame", "device.idle_aux_pct"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_cell_resolves_its_pieces(bench):
    cell = spec.workload(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "amr_table", "frame_repeat_table_large", 1)
    data, module = spec.config(cell["config"])
    assert data["instantiation"] == "packed_cyl2+aux+nt"
    assert (data["tau_calculation"], data["nonthermal_e_dist"]) == ("TABLE", "POWERLAW")
    assert (data["powerlaw_index"], data["gamma_min"], data["gamma_max"]) == (2.5, 1.0, 100.0)
    assert (data["n_gamma"], data["epsilon_b"], data["t_comov_set"]) == (3, 0.5, 5e8)
    amr, nt = spec.config("amr_jet")[0], spec.config("cyl2_nt")[0]
    for key in ("blocks", "outflow", "max_rounds_per_frame", "frame_window_s", "dtype",
                "stokes"):
        assert data[key] == amr[key], key
    assert data["injection"] == nt["injection"] == amr["injection"]
    assert data["reduced"] == [] and data["limits"] == amr["limits"]
    assert module.reference is amr_table
    for name in ("inputs", "transport_window", "cell_holds", "photons_from_arrays"):
        assert callable(getattr(module.reference, name))
    mix, kind = spec.mix(cell["traffic"])
    assert mix.kind == "frame_repeat_table"
    assert mix.params == dict(min_photons=6_000_000, max_photons=14_000_000, chunk_rounds=64)
    assert (mix.warmup_windows, mix.trace_windows, mix.sync_windows) == (4, 5, 2)
    for name in ("setup", "window", "check", "fields", "before", "reference_generator"):
        assert callable(getattr(kind, name))


def test_cell_reports_its_metrics(bench):
    end = {m["name"] for m in spec.metrics_of(bench, CELL, False)}
    assert end == {"photon_frames_per_s", "frame_ms_p90", "peak_mem_gib", "setup_s"}
    layer = {m["name"] for m in spec.metrics_of(bench, CELL, True)}
    assert layer == OWN
    for m in bench["per_layer"]:
        if m["name"] in OWN:
            assert m["workloads"] == [CELL] and m["moves"] == "photon_frames_per_s"
            spec.metric_reader(m["name"])


def test_least_time_by_hand():
    data, module = spec.config("amr_table")
    n, s, cells = 1000, 500, 100
    rounds = n + s  # 1,500; one TABLE rate evaluation each
    nbytes = n * 2 * 64 + cells * 10 * 4  # 132,000
    # FP32: per round 41 + 37 + 8 + 12 + 39 (the TABLE rate) = 137; per
    # scattering 167 + 434 + 16 + 23 + 27 (one Maxwell-Juttner trial) = 667
    ops = rounds * 137 + s * 667
    # math calls: per round sqrt 2+1+1+1 = 5, div 3+2+2+1 = 8, log 1+1 = 2,
    # rsqrt 1, exp 4; per scattering div 8+15+2+3 = 28, sqrt 8+10+1 = 19,
    # rsqrt 4+7 = 11, sincos 1, log 1
    sqrt, div, log = 5 * rounds + 19 * s, 8 * rounds + 28 * s, 2 * rounds + s
    rsqrt, exp = rounds + 11 * s, 4 * rounds
    ops += sqrt * 5 + div * 9 + log * 26 + rsqrt * 1 + exp * 9 + s * 31
    sfu = sqrt + div + rsqrt + exp
    # uniforms roofline.UNIFORMS counts: a round 1, a scattering 3 + 2 + 2
    uniforms = rounds + s * 7
    want = dict(bytes=nbytes / 3.35e12, fp32=ops / 67e12,
                int32=uniforms * 12 / (64 * 132 * 1.98e9), sfu=sfu / (16 * 132 * 1.98e9))
    got, pipe = module.least_time(data, n, s, cells)
    assert pipe == max(want, key=want.get)
    assert got == pytest.approx(want[pipe], rel=1e-12)
    # the bytes bind with few scatterings
    assert module.least_time(data, 10, 5, 2) == pytest.approx(((10 * 128 + 2 * 40) / 3.35e12,
                                                                "bytes"))
    units = module.frame_units(10, 4)
    assert "mb" not in units and units["table_rate"] == units["lane_round"] == 14
    assert units["mj_trial"] == units["scatter_stokes"] == 4
    assert roofline.frame_bytes(10, 2, module.ROWS_PER_CELL) == 10 * 128 + 2 * 40


def test_readers_read_the_programs_records():
    lanes = spec.metric_reader("transport.aux_lanes_per_frame")
    aux = spec.metric_reader("transport.aux_planes_stream_ms")
    summ = dict(frames=4, counters={"transport.aux_lanes": 4_000_000},
                spans={"transport.aux_planes": dict(count=40, stream_ms=20.0)})
    assert lanes.value(summ) == pytest.approx(1_000_000)
    assert aux.value(summ) == pytest.approx(5.0)
    # a program without the counter or the span (the parent's, a DIRECT
    # frame), or no traced frame: nothing to read
    empty = dict(frames=4, counters={}, spans={})
    for reader in (lanes, aux):
        assert reader.value(empty) is None
        assert reader.value(dict(summ, frames=0)) is None
        assert reader.value(None) is None
    assert aux.value(dict(summ, spans={"transport.aux_planes": dict(count=4,
                                                                     stream_ms=None)})) is None
    # no traced window: the device's readers read nothing
    rec = types.SimpleNamespace(trace=None)
    for name in ("fused_round_aux.kernel_ms", "fused_round_aux_roofline", "device.idle_aux_pct"):
        assert spec.metric_reader(name).read(rec) is None
    trace = types.SimpleNamespace(fused_kernels=10, fused_s=0.02, windows=2, busy_s=0.3,
                                  wall_s=0.5)
    data, module = spec.config("amr_table")
    rec = types.SimpleNamespace(trace=trace, spec=data, config=module, n_photons=1000,
                                trace_n_scatt=[500, 500], n_cells_held=100)
    assert spec.metric_reader("fused_round_aux.kernel_ms").read(rec) == pytest.approx(10.0)
    least = 2 * module.least_time(data, 1000, 500, 100)[0]
    assert spec.metric_reader("fused_round_aux_roofline").read(rec) == pytest.approx(
        100 * least / 0.02)
    assert spec.metric_reader("device.idle_aux_pct").read(rec) == pytest.approx(40.0)
