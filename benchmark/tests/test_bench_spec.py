"""BENCHMARK.json keeps the contract's names, keys and limits, and every
file a cell needs is found by name."""
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import spec, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_keys_and_sizes(bench):
    assert set(bench) == TOP_KEYS
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert not p.startswith("/")
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    for n in names + [w["config"] for w in bench["workloads"]] + \
            [w["traffic"] for w in bench["workloads"]] + \
            [k for c in bench["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in bench[group]]
        assert len(ns) == len(set(ns))
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in bench["configs"] + bench["workloads"]]
                 + [c["source"] for c in bench["configs"]]
                 + [m["layer"] for m in bench["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_cells_report_what_they_must(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in bench["workloads"]} == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        reported = {m["name"] for m in spec.metrics_of(bench, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics_of(bench, w["name"], True)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in spec.metrics_of(bench, cell, False)}


def test_every_file_is_found_by_name(bench):
    for c in bench["configs"]:
        data, builder = spec.config(c["name"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert Path(spec.ROOT / c["file"]).is_file()
        assert set(data["reduced"]) == set(c["reduced"])
        assert callable(builder.build_host) and callable(builder.least_time)
        assert callable(builder.reference.transport_window)
        assert callable(builder.reference.cell_holds)
        assert set(data["limits"]) == {"windows_off_path", "photons_off", "scatter_count_off",
                                       "stat_z_max"}
    for w in bench["workloads"]:
        mix, kind = spec.mix(w["traffic"])
        assert set(kind.PARAMS) <= set(mix.params)
        assert all(callable(getattr(kind, f)) for f in ("setup", "window", "check"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def test_added_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_benchmark()
    (root / "benchmark" / "metrics" / "extra.glue_share.py").write_text(
        "def read(rec):\n    return 42.0\n")
    (root / "benchmark" / "traffic" / "frame_repeat_tiny.json").write_text(json.dumps(
        dict(spec.traffic("frame_repeat"), min_photons=10, max_photons=20)))
    (root / "benchmark" / "kinds" / "frame_chain.py").write_text(
        "PARAMS = ('hops',)\n"
        "def setup(spec, config, mix, seed, device):\n    return None\n"
        "def window(prob, generator):\n    return None\n"
        "def check(prob, config, state, seed, device):\n    return {}\n")
    (root / "benchmark" / "traffic" / "chain_tiny.json").write_text(json.dumps(
        dict(kind="frame_chain", warmup_windows=1, trace_windows=1, sync_windows=1, hops=3)))
    data = json.loads((root / "benchmark" / "configs" / "cyl2_jet.json").read_text())
    (root / "benchmark" / "configs" / "cyl2_twin.json").write_text(
        json.dumps(dict(data, name="cyl2_twin")))
    shutil.copy(root / "benchmark" / "configs" / "cyl2_jet.py",
                root / "benchmark" / "configs" / "cyl2_twin.py")
    bench["configs"].append(dict(bench["configs"][0], name="cyl2_twin",
                                 file="benchmark/configs/cyl2_twin.json"))
    bench["workloads"].append(dict(name="cyl2_twin.tiny", config="cyl2_twin",
                                   traffic="frame_repeat_tiny", chips=1, why="a test"))
    bench["per_layer"].append(dict(name="extra.glue_share", unit="%", better="lower",
                                   source="device_trace", layer="transport glue",
                                   moves="photon_frames_per_s"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = spec.load_benchmark(root)
    cell = spec.workload(loaded, "cyl2_twin.tiny")
    bench_dir = root / "benchmark"
    assert spec.config(cell["config"], bench_dir)[0]["name"] == "cyl2_twin"
    assert spec.mix(cell["traffic"], bench_dir)[0].params["max_photons"] == 20
    chain, chain_kind = spec.mix("chain_tiny", bench_dir)
    assert chain.kind == "frame_chain" and chain.params == {"hops": 3}
    assert chain_kind.PARAMS == ("hops",)
    with pytest.raises(ValueError):
        traffic.mix("bad", dict(kind="frame_chain", warmup_windows=1), chain_kind.PARAMS)
    names = [m["name"] for m in spec.metrics_of(loaded, "cyl2_twin.tiny", True)]
    assert "extra.glue_share" in names
    assert spec.metric_reader("extra.glue_share", bench_dir).read(None) == 42.0
