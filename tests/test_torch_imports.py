"""The PyTorch port imports torch and numpy, never jax or flax, and nothing of
the JAX package mcrat_tpu: it keeps its own ``config`` and ``constants``.
h5py is imported only inside the functions that read or write HDF5, so the
driver, the CLI and the npz dumps run on a machine without it."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "mcrat_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "frame_spans.py",
    ROOT / "tools" / "kernel_ab.py", ROOT / "tools" / "sass_counts.py",
    ROOT / "tools" / "mesh_seeds.py"]
ALLOWED_FROM_JAX_PACKAGE = set()


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
    assert {"transport.py", "grid.py", "fused_round.py", "config.py", "constants.py",
            "chip_smoke.py", "frame_spans.py", "kernel_ab.py", "sass_counts.py",
            "driver.py", "cli.py", "checkpoint.py", "photons_h5.py", "mcpar.py",
            "analysis.py", "prng.py", "stokes.py", "compton.py", "electrons.py", "pluto.py",
            "pluto_chombo.py", "riken.py", "mesh.py", "dryrun.py", "serial.py",
            "telemetry.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_h5py(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    top = [a.name for node in tree.body if isinstance(node, ast.Import) for a in node.names]
    top += [node.module for node in tree.body if isinstance(node, ast.ImportFrom)]
    assert not any(m and m.split(".")[0] == "h5py" for m in top), path


def test_entry_points_import_without_jax_or_h5py():
    """A fresh interpreter imports the package, its driver, CLI, persistence
    and analysis and loads neither jax nor h5py nor the JAX package."""
    code = ("import sys; import mcrat_tpu_torch, mcrat_tpu_torch.cli, mcrat_tpu_torch.driver, "
            "mcrat_tpu_torch.io.checkpoint, mcrat_tpu_torch.io.photons_h5, "
            "mcrat_tpu_torch.analysis, mcrat_tpu_torch.parallel, "
            "mcrat_tpu_torch.parallel.dryrun, mcrat_tpu_torch.serial; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'h5py', 'mcrat_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device=`` every entry point puts its tensors on the card,
    and without a card it raises: nothing falls back to the CPU."""
    import numpy as np
    import torch

    from mcrat_tpu_torch import DEFAULT_DEVICE, Config, Dims, Geometry, convert, transport
    from mcrat_tpu_torch.grid import build_binned_index, build_rectilinear_index
    from mcrat_tpu_torch.grid import frame_from_numpy
    from mcrat_tpu_torch.io.hydro import build_index
    from mcrat_tpu_torch.models.analytic import make_grid_2d
    from mcrat_tpu_torch.ops import hot_xsec
    from mcrat_tpu_torch.parallel import make_mesh
    from mcrat_tpu_torch.parallel.dryrun import dryrun_multichip

    assert DEFAULT_DEVICE == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL)
    edges = (np.linspace(0.0, 1.0, 3), np.linspace(1.0, 2.0, 3))
    host = frame_from_numpy(cfg, make_grid_2d(cfg, *edges))
    arrays = {k: np.zeros((1, 4) if k in ("p", "comv_p", "s") else (1, 3) if k == "pos"
                          else 1) for k in convert.PHOTON_FIELDS}
    calls = [
        lambda: host.to_device(),
        lambda: build_rectilinear_index(*edges),
        lambda: build_binned_index(host),
        lambda: build_index(cfg, host),
        lambda: transport.empty_photons(4),
        lambda: transport.photons_from_arrays(arrays),
        lambda: hot_xsec.load_or_build(cfg),
        lambda: convert.photons_from_numpy(arrays),
        lambda: convert.index_from_edges(*edges),
        lambda: convert.binned_index_from_numpy(np.zeros(4), np.zeros(1), np.full(1, 4),
                                                np.zeros(3), np.ones(3), (1, 1, 1), 4),
        lambda: make_mesh(),
        lambda: dryrun_multichip(2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert host.to_device("cpu").packed.device.type == "cpu"
