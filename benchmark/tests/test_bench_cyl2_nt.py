"""The nonthermal jet cell, ``cyl2_nt.frame``: it finds its configuration,
mix, kind and reference by name, reports the four end-to-end metrics and
its own three per-layer metrics, its least time matches a hand count, and
its readers read what the program records."""
import types

import pytest

from benchmark import roofline, spec
from benchmark.reference import table

CELL = "cyl2_nt.frame"
OWN = {"fused_round_nt.kernel_ms", "fused_round_nt_roofline", "hot_xsec.fit_stream_ms"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_cell_resolves_its_pieces(bench):
    cell = spec.workload(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("cyl2_nt", "frame_repeat_table", 1)
    data, module = spec.config(cell["config"])
    assert data["instantiation"] == "packed_cyl2+cheb+nt"
    assert (data["tau_calculation"], data["nonthermal_e_dist"]) == ("TABLE", "POWERLAW")
    assert (data["powerlaw_index"], data["gamma_min"], data["gamma_max"]) == (2.5, 1.0, 100.0)
    assert (data["n_gamma"], data["epsilon_b"], data["t_comov_set"]) == (3, 0.5, 5e8)
    assert data["reduced"] == [] and data["limits"] == spec.config("cyl2_jet")[0]["limits"]
    assert module.reference is table
    for name in ("inputs", "transport_window", "cell_holds", "photons_from_arrays"):
        assert callable(getattr(module.reference, name))
    mix, kind = spec.mix(cell["traffic"])
    base, _ = spec.mix("frame_repeat")
    assert (mix.kind, mix.params) == ("frame_repeat_table", base.params)
    assert (mix.warmup_windows, mix.trace_windows, mix.sync_windows) == (
        base.warmup_windows, base.trace_windows, base.sync_windows)
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
    data, module = spec.config("cyl2_nt")
    n, s, cells = 1000, 500, 100
    rounds = n + s  # 1,500
    nbytes = n * 2 * 64 + cells * 26 * 4  # 138,400
    # FP32: per round 41 + 37 + 53 (CHEB_NT) + 8 + 12 = 151; per scattering
    # 167 + 434 + 16 + 23 + 27 (one Maxwell-Juttner trial) = 667
    ops = rounds * 151 + s * 667
    # math calls: per round sqrt 1+1+2+1 = 5, div 2+3+2+1 = 8, log 1, rsqrt 1,
    # exp 2; per scattering div 8+15+2+3 = 28, sqrt 8+10+1 = 19,
    # rsqrt 4+7 = 11, sincos 1, log 1
    sqrt, div, log = 5 * rounds + 19 * s, 8 * rounds + 28 * s, rounds + s
    rsqrt, exp = rounds + 11 * s, 2 * rounds
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
    assert module.least_time(data, 10, 5, 2) == pytest.approx(((10 * 128 + 2 * 104) / 3.35e12,
                                                                "bytes"))
    units = module.frame_units(10, 4)
    assert "mb" not in units and units["cheb_nt"] == units["lane_round"] == 14
    assert units["mj_trial"] == units["scatter_stokes"] == 4
    assert roofline.frame_bytes(10, 2, module.ROWS_PER_CELL) == 10 * 128 + 2 * 104


def test_readers_read_the_programs_records():
    fit = spec.metric_reader("hot_xsec.fit_stream_ms")
    summ = dict(frames=4, counters={}, spans={
        "hot_xsec.cheb_cells": dict(count=4, stream_ms=6.0),
        "hot_xsec.nt_constants": dict(count=4, stream_ms=2.0)})
    assert fit.value(summ) == pytest.approx(2.0)
    summ["spans"].pop("hot_xsec.nt_constants")
    assert fit.value(summ) == pytest.approx(1.5)
    assert fit.value(dict(frames=4, counters={}, spans={})) is None
    assert fit.value(dict(frames=0, counters={}, spans={})) is None
    assert fit.value(None) is None
    # no traced window: the kernel's readers read nothing
    rec = types.SimpleNamespace(trace=None)
    for name in ("fused_round_nt.kernel_ms", "fused_round_nt_roofline"):
        assert spec.metric_reader(name).read(rec) is None
    trace = types.SimpleNamespace(fused_kernels=10, fused_s=0.02, windows=2)
    data, module = spec.config("cyl2_nt")
    rec = types.SimpleNamespace(trace=trace, spec=data, config=module, n_photons=1000,
                                trace_n_scatt=[500, 500], n_cells_held=100)
    assert spec.metric_reader("fused_round_nt.kernel_ms").read(rec) == pytest.approx(10.0)
    least = 2 * module.least_time(data, 1000, 500, 100)[0]
    assert spec.metric_reader("fused_round_nt_roofline").read(rec) == pytest.approx(
        100 * least / 0.02)
