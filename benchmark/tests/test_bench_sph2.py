"""The spherical fireball cell, ``sph2_fireball.frame``: it finds its
configuration, mix, kind and reference by name, reports the four
end-to-end metrics and its own five per-layer metrics, its least time
matches a hand count and falls with the kernel's work, and its readers read
what the program records."""
import types

import pytest

from benchmark import roofline, spec
from benchmark.reference import sph2

CELL = "sph2_fireball.frame"
OWN = {"fused_round_sph2.kernel_ms", "fused_round_sph2_roofline", "device.idle_sph2_pct",
       "grid.lookup_sph2_stream_ms", "transport.partition_sph2_stream_ms"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_cell_resolves_its_pieces(bench):
    cell = spec.workload(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("sph2_fireball",
                                                                "frame_repeat_large", 1)
    data, module = spec.config(cell["config"])
    assert data["instantiation"] == "packed_sph2"
    assert (data["geometry"], data["dims"], data["simulation_type"]) == ("SPHERICAL", 2,
                                                                          "SPHERICAL_OUTFLOW")
    assert data["outflow"] == {"gamma_infinity": 100.0, "lumi": 1e54, "r00": 1e8}
    assert data["grid"] == {"r_min": 1e12, "r_max": 9e13, "nr": 384, "ntheta": 64,
                            "theta_max": 0.31416, "log_r": True}
    assert data["frame_window_s"] == 1.0 and data["injection"]["fps"] == 1.0
    assert data["reduced"] == [] and data["limits"] == spec.config("cyl2_jet")[0]["limits"]
    assert module.reference is sph2
    for name in ("inputs", "transport_window", "cell_holds", "photons_from_arrays"):
        assert callable(getattr(module.reference, name))
    mix, kind = spec.mix(cell["traffic"])
    assert mix.kind == "frame_repeat"
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
            assert callable(spec.metric_reader(m["name"]).read)


def test_least_time_by_hand():
    data, module = spec.config("sph2_fireball")
    n, s, cells = 1000, 500, 100
    rounds = n + s  # 1,500
    nbytes = n * 2 * 64 + cells * 11 * 4  # 132,400
    # FP32: per round 41 + 37 + 14 + 20 = 112; per scattering
    # 167 + 22 + 434 + 16 + 23 = 662
    ops = rounds * 112 + s * 662
    # math calls: per round sqrt 2+1+1+2 = 6, div 3+2+2+1 = 8, log 1,
    # rsqrt 1; per scattering div 8+15+2+3 = 28, sqrt 8+10+1 = 19,
    # rsqrt 4+7+1 = 12, sincos 1, cos 1, log 2
    sqrt, div, log = 6 * rounds + 19 * s, 8 * rounds + 28 * s, rounds + 2 * s
    rsqrt, cos = rounds + 12 * s, s
    ops += sqrt * 5 + div * 9 + log * 26 + rsqrt * 1 + cos * 19 + s * 31
    sfu = sqrt + div + rsqrt
    # uniforms: a round 1, a scattering 3 + 3 + 2 + 2
    uniforms = rounds + s * 10
    want = dict(bytes=nbytes / 3.35e12, fp32=ops / 67e12,
                int32=uniforms * 12 / (64 * 132 * 1.98e9), sfu=sfu / (16 * 132 * 1.98e9))
    got, pipe = module.least_time(data, n, s, cells)
    assert pipe == max(want, key=want.get)
    assert got == pytest.approx(want[pipe], rel=1e-12)
    # the bytes bind with few scatterings
    assert module.least_time(data, 10, 5, 2) == pytest.approx(((10 * 128 + 2 * 44) / 3.35e12,
                                                                "bytes"))


@pytest.mark.parametrize("n,s,cells", [(9_500_000, 7_000_000, 44), (954_016, 700_000, 44),
                                         (100_000, 4_000_000, 44)])
def test_least_time_is_positive_and_falls_with_the_work(n, s, cells):
    data, module = spec.config("sph2_fireball")
    base, pipe = module.least_time(data, n, s, cells)
    assert base > 0
    # less work never takes longer, and half of all of it takes half
    for fewer in ((n // 2, s, cells), (n, s // 2, cells), (n, s, cells // 2)):
        assert module.least_time(data, *fewer)[0] <= base
    assert module.least_time(data, n // 2, s // 2, cells // 2)[0] < base
    # the kernel's per-round geometry counts: fewer operations or calls a
    # round take no longer, and less time where a compute pipe binds
    units = roofline.frame_units(n, s, True)
    nbytes = roofline.frame_bytes(n, cells, module.ROWS_PER_CELL)
    assert roofline.least_time(units, nbytes, module.OPS_GEO, module.CALLS_GEO)[0] == base
    cheaper = roofline.least_time(units, nbytes, (7, 10),
                                  (dict(sqrt=1, div=1), dict(sqrt=1, div=1)))[0]
    assert cheaper <= base
    if pipe != "bytes":
        assert cheaper < base
    # a sph2 round costs no less than a cyl2 round
    cyl2 = roofline.least_time(units, nbytes, roofline.OPS_GEO_CYL2,
                               roofline.CALLS_GEO_CYL2)[0]
    assert base >= cyl2


def test_readers_read_the_programs_records():
    part = spec.metric_reader("transport.partition_sph2_stream_ms")
    summ = dict(frames=4, counters={}, spans={
        "transport.partition": dict(count=12, stream_ms=6.0),
        "grid.lookup": dict(count=20, stream_ms=10.0)})
    assert part.value(summ) == pytest.approx(1.5)
    assert spec.metric_reader("grid.lookup_stream_ms").value(summ) == pytest.approx(2.5)
    assert part.value(dict(frames=4, counters={}, spans={})) is None
    assert part.value(dict(frames=4, counters={}, spans={
        "transport.partition": dict(count=1, stream_ms=None)})) is None
    assert part.value(dict(frames=0, counters={}, spans={})) is None
    assert part.value(None) is None
    # no traced window: the device readers read nothing
    rec = types.SimpleNamespace(trace=None)
    for name in ("fused_round_sph2.kernel_ms", "fused_round_sph2_roofline",
                 "device.idle_sph2_pct"):
        assert spec.metric_reader(name).read(rec) is None
    trace = types.SimpleNamespace(fused_kernels=10, fused_s=0.02, windows=2, busy_s=0.03,
                                  wall_s=0.04)
    data, module = spec.config("sph2_fireball")
    rec = types.SimpleNamespace(trace=trace, spec=data, config=module, n_photons=1000,
                                trace_n_scatt=[500, 500], n_cells_held=100)
    assert spec.metric_reader("fused_round_sph2.kernel_ms").read(rec) == pytest.approx(10.0)
    least = 2 * module.least_time(data, 1000, 500, 100)[0]
    assert spec.metric_reader("fused_round_sph2_roofline").read(rec) == pytest.approx(
        100 * least / 0.02)
    assert spec.metric_reader("device.idle_sph2_pct").read(rec) == pytest.approx(25.0)
