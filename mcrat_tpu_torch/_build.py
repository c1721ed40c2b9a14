"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface under ``build/mcrat_tpu_torch/``
of the repository (git-ignored), named by a hash of its source and flags, and
loaded with ``ctypes``.  The build runs at first use; a process reuses the
loaded library.  Nothing here runs at import time.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build" / "mcrat_tpu_torch"
FUSED_ROUND_SRC = PKG_DIR / "csrc" / "fused_round.cu"
BINNED_SEARCH_SRC = PKG_DIR / "csrc" / "binned_search.cu"
DIRECT_LOOKUP_SRC = PKG_DIR / "csrc" / "direct_lookup.cu"

# FMA contraction off: the kernel keeps its plain twin's rounding, op by op
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false",
]
# csrc/fused_round.cu is split into translation units: compiled once with
# each -DMCRAT_FAMILY=<code> and once without (its entry points), side by
# side, then linked
N_FAMILIES = 5
FUSED_ROUND_UNITS = tuple((f"-DMCRAT_FAMILY={k}",) for k in range(N_FAMILIES)) + ((),)

_loaded: dict = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def run(cmd: list) -> subprocess.CompletedProcess:
    """Run a compiler command; raise with its output if it fails."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc


def source_bytes(src: Path) -> bytes:
    """``src`` followed by each header beside it that it includes
    (``#include "name.cuh"``), in the order it includes them."""
    text = src.read_bytes()
    headers = re.findall(rb'^#include "([\w.]+)"', text, flags=re.M)
    return text + b"".join((src.parent / h.decode()).read_bytes() for h in headers)


def build(src: Path = FUSED_ROUND_SRC, units=FUSED_ROUND_UNITS) -> dict:
    """Compile ``src`` unless its library exists: one nvcc for each of its
    translation ``units`` (each unit's extra flags; by default the fused
    round's N_FAMILIES families, ``-DMCRAT_FAMILY=<code>``, and its entry
    points), all started together, then one link.  The library's name holds
    a hash of the source, the headers it includes (:func:`source_bytes`) and
    NVCC_FLAGS.  Returns a dict with the library
    ``path``, whether it was ``built`` now and the build ``seconds``."""
    tag = hashlib.sha256(source_bytes(src) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    if lib.exists():
        return dict(path=lib, built=False, seconds=0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, lib.name)
        objs = [os.path.join(tmp, f"unit{i}.o") for i in range(len(units))]
        with concurrent.futures.ThreadPoolExecutor(len(units)) as ex:
            list(ex.map(lambda u: run([nvcc, *NVCC_FLAGS, *u[0], "-c", "-o", u[1], str(src)]),
                        zip(units, objs)))
        run([nvcc, "-shared", "-o", out, *objs])
        os.replace(out, lib)
    return dict(path=lib, built=True, seconds=time.perf_counter() - t0)


def bind_fused_round(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the ctypes signatures of a fused-round library's C entry points
    (``mcrat_fused_rounds``, ``mcrat_fused_rounds_mapped`` where the build
    has it, ``mcrat_kn_cross_section``, ``mcrat_error_string``;
    ``fused_round.kernel_attributes`` declares ``mcrat_fused_rounds_attrs``,
    which older builds lack), so that any build of ``fused_round.cu`` loads
    the same way.  Returns ``lib``."""
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    call = [
        i32, i32,  # variant code, optical-depth family
        p, i64, p, p, p, i64, p, p, i32,  # state, n, cell, flags, table, ncell, block_act, out, seed
        *[f32] * 6,  # domain
        *[f32] * 6, i32, i32,  # lo0, d0, lo1, d1, lo2, d2, n1, n2
        i32, i32, i32, i32, i32,  # stokes_on, inner_rounds, el_iters, kn_iters, block_lanes
        f32, f32, f32, f32, f32,  # kb_over_mec2, thom, c_light, inv_c, inv_mp
        i32, ctypes.POINTER(f32), i32,  # cheb_base, NtConsts floats (host), their count
        p,  # aux planes (device, or NULL)
    ]
    lib.mcrat_fused_rounds.argtypes = [*call, p]  # stream
    lib.mcrat_fused_rounds.restype = ctypes.c_int
    if hasattr(lib, "mcrat_fused_rounds_mapped"):  # builds since the row map
        lib.mcrat_fused_rounds_mapped.argtypes = [*call, p, p]  # row map (device), stream
        lib.mcrat_fused_rounds_mapped.restype = ctypes.c_int
    lib.mcrat_kn_cross_section.argtypes = [p, p, i64, p]  # energies, out, n, stream
    lib.mcrat_kn_cross_section.restype = ctypes.c_int
    lib.mcrat_error_string.argtypes = [ctypes.c_int]
    lib.mcrat_error_string.restype = ctypes.c_char_p
    return lib


def load_fused_round() -> ctypes.CDLL:
    """The fused-round kernel library, built on first use."""
    if "fused_round" not in _loaded:
        _loaded["fused_round"] = bind_fused_round(
            ctypes.CDLL(str(build(FUSED_ROUND_SRC)["path"])))
    return _loaded["fused_round"]


def bind_binned_search(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the ctypes signatures of the carried lookup library's C entry
    points (``mcrat_carried_lookup``, ``mcrat_binned_search_error_string``).
    Returns ``lib``."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.mcrat_carried_lookup.argtypes = [
        i32, i32, i32, i32,  # geometry, lanes in float64, frame in float64, three_d
        p, i64, i64, i64, p,  # pos, lane stride, axis stride, n, cached
        p, p, p, p, p, p, i32,  # the frame's r0, r1, r2, dr0, dr1, dr2, n_cell
        p, p, p, p, p,  # params, cell_ids, bin_start, bin_count, geometry rows
        i32, i32, i32, i32,  # d0, d1, d2, max_slab
        p, p, p, p, p, p,  # cell, in_grid (or NULL), alive, pool, safe, flags
        i32, i32, i32,  # flag_alive, flag_pool, flag_ingrid
        p, p,  # searched (or NULL), stream
    ]
    lib.mcrat_carried_lookup.restype = ctypes.c_int
    lib.mcrat_binned_search_error_string.argtypes = [ctypes.c_int]
    lib.mcrat_binned_search_error_string.restype = ctypes.c_char_p
    return lib


def load_binned_search() -> ctypes.CDLL:
    """The carried AMR lookup's library (``csrc/binned_search.cu``, one
    translation unit), built on first use."""
    if "binned_search" not in _loaded:
        _loaded["binned_search"] = bind_binned_search(
            ctypes.CDLL(str(build(BINNED_SEARCH_SRC, units=((),))["path"])))
    return _loaded["binned_search"]


def bind_direct_lookup(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the ctypes signatures of the direct lookup library's C entry
    points (``mcrat_direct_lookup``, ``mcrat_direct_lookup_error_string``).
    Returns ``lib``."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.mcrat_direct_lookup.argtypes = [
        i32, i32, i32,  # geometry, lanes in float64, edges in float64
        p, i64, i64, i64,  # pos, lane stride, axis stride, n
        p, p, p, p,  # params, edges of axes 0, 1, 2
        i32, i32, i32, i32, i32,  # n0, n1, n2, uniform axes (bits), three_d
        p, p, p, p, p, p,  # cell, in_grid (or NULL), alive, pool, safe, flags
        i32, i32, i32, i32,  # n_cell, flag_alive, flag_pool, flag_ingrid
        p,  # stream
    ]
    lib.mcrat_direct_lookup.restype = ctypes.c_int
    lib.mcrat_direct_lookup_error_string.argtypes = [ctypes.c_int]
    lib.mcrat_direct_lookup_error_string.restype = ctypes.c_char_p
    return lib


def load_direct_lookup() -> ctypes.CDLL:
    """The direct lookup's library (``csrc/direct_lookup.cu``, one
    translation unit), built on first use."""
    if "direct_lookup" not in _loaded:
        _loaded["direct_lookup"] = bind_direct_lookup(
            ctypes.CDLL(str(build(DIRECT_LOOKUP_SRC, units=((),))["path"])))
    return _loaded["direct_lookup"]
