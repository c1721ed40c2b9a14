"""The PyTorch port imports torch and numpy, never jax or flax, and takes only
the pure-Python ``config`` and ``constants`` modules from mcrat_tpu."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "mcrat_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_frames.py"]
ALLOWED_FROM_JAX_PACKAGE = {"mcrat_tpu", "mcrat_tpu.config", "mcrat_tpu.constants"}


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            if node.module == "mcrat_tpu":
                for alias in node.names:
                    yield f"mcrat_tpu.{alias.name}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_only_config_constants(path):
    mods = list(_imported_modules(path))
    top = {m.split(".")[0] for m in mods}
    assert not top & {"jax", "jaxlib", "flax"}, (path, mods)
    from_ref = {m for m in mods if m.split(".")[0] == "mcrat_tpu"}
    assert from_ref <= ALLOWED_FROM_JAX_PACKAGE, (path, from_ref)


def test_package_sources_found():
    names = {p.name for p in SOURCES}
    assert {"transport.py", "grid.py", "fused_round.py", "chip_smoke.py",
            "profile_torch_frames.py"} <= names
