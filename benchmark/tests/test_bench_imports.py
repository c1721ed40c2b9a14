"""No benchmark run loads JAX or the JAX package, the reference imports
nothing of the program, and a run that cannot run prints no result."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "mcrat_tpu"}
PROGRAM = "mcrat_tpu_torch"


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_and_the_reference_imports_no_program():
    files = [p for p in spec.BENCH_DIR.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not imported_top_names(p) & FORBIDDEN, p
    for p in (spec.BENCH_DIR / "reference").rglob("*.py"):
        assert PROGRAM not in imported_top_names(p), p
        assert "benchmark" not in imported_top_names(p), p
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "mcrat_tpu")


def test_a_run_loads_no_jax(small_mix):
    """A whole run of a cell on the CPU in a fresh process, then every
    loaded module's top-level name, compared whole."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "out = harness.run('amr_jet.frame', 9, 0.05, False, device='cpu', mix_override=%r)\n"
        "print(json.dumps([out['correct'], sorted({m.split('.')[0] for m in sys.modules})]))\n"
    ) % (str(spec.ROOT), small_mix)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    correct, names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert correct is True
    assert PROGRAM in names and not FORBIDDEN & set(names)


def test_no_card_no_result():
    """On a machine without the card the command exits non-zero and prints
    nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        return
    cmd = spec.load_benchmark()["command"]
    proc = subprocess.run([sys.executable, *cmd[1:], "--workload", "cyl2_jet.frame", "--seed",
                           "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                          text=True, timeout=300, cwd=spec.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    lacks the program: the run stops before any result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import harness\n"
            "print(harness.run('cyl2_jet.frame', 1, 0.05, False, device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path, env=env)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "mcrat_tpu_torch" in proc.stderr
