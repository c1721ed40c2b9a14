"""BENCHMARK.json and the files the harness finds by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
harness loads ``benchmark/configs/<config>.json`` with its module
``benchmark/configs/<config>.py`` (the program's set-up, ``build_host``; the
plain reference, ``reference``; the kernel's least time, ``least_time``),
``benchmark/traffic/<traffic>.json`` with the module of its kind,
``benchmark/kinds/<kind>.py``, and, for each metric the cell reports,
``benchmark/metrics/<metric>.py``.  A new configuration, mix, kind or
metric is new files plus new entries: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                   f"{[c['name'] for c in bench['workloads']]}")


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: the per-layer ones in a traced
    run, else the end-to-end ones; a metric with ``workloads`` only in
    those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name`` (file names may
    hold dots, so they are loaded by path, not imported by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    mod_spec.loader.exec_module(mod)
    return mod


def config(name: str, bench_dir: Path = BENCH_DIR):
    """(the configuration's JSON, its module)."""
    with open(bench_dir / "configs" / f"{name}.json") as f:
        data = json.load(f)
    return data, load_module(bench_dir / "configs" / f"{name}.py", f"benchmark_config_{name}")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


def kind(name: str, bench_dir: Path = BENCH_DIR):
    """The module of a traffic kind."""
    return load_module(bench_dir / "kinds" / f"{name}.py", f"benchmark_kind_{name}")


def mix(name: str, bench_dir: Path = BENCH_DIR, override: Optional[dict] = None):
    """(the mix ``name``, the module of its kind); ``override`` replaces
    parameters of the file (a test's smaller mix)."""
    from . import traffic as tf

    params = dict(traffic(name, bench_dir), **(override or {}))
    module = kind(params["kind"], bench_dir)
    return tf.mix(name, params, module.PARAMS), module


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The reader of one metric: a module with ``read(record)`` that returns
    the metric's value, or None where the record holds nothing to read."""
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_"))
