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
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parent / "build" / "mcrat_tpu_torch"
FUSED_ROUND_SRC = PKG_DIR / "csrc" / "fused_round.cu"

# FMA contraction off: the kernel keeps its plain twin's rounding, op by op
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false",
]
# the source is split into translation units (csrc/fused_round.cu): compiled
# once with each -DMCRAT_FAMILY=<code> and once without, side by side, then
# linked
N_FAMILIES = 5

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


def build(src: Path = FUSED_ROUND_SRC) -> dict:
    """Compile ``src`` unless its library exists: one nvcc for each of its
    N_FAMILIES families' translation units (``-DMCRAT_FAMILY=<code>``) and
    one for its entry points, all started together, then one link.  Returns
    a dict with the library ``path``, whether it was ``built`` now and the
    build ``seconds``."""
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    if lib.exists():
        return dict(path=lib, built=False, seconds=0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, lib.name)
        units = [[f"-DMCRAT_FAMILY={k}"] for k in range(N_FAMILIES)] + [[]]
        objs = [os.path.join(tmp, f"unit{i}.o") for i in range(len(units))]
        with concurrent.futures.ThreadPoolExecutor(len(units)) as ex:
            list(ex.map(lambda u: run([nvcc, *NVCC_FLAGS, *u[0], "-c", "-o", u[1], str(src)]),
                        zip(units, objs)))
        run([nvcc, "-shared", "-o", out, *objs])
        os.replace(out, lib)
    return dict(path=lib, built=True, seconds=time.perf_counter() - t0)


def bind_fused_round(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the ctypes signatures of a fused-round library's C entry points
    (``mcrat_fused_rounds``, ``mcrat_kn_cross_section``,
    ``mcrat_error_string``; ``fused_round.kernel_attributes`` declares
    ``mcrat_fused_rounds_attrs``, which older builds lack), so that
    any build of ``fused_round.cu`` loads the same way.  Returns ``lib``."""
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    lib.mcrat_fused_rounds.argtypes = [
        i32, i32,  # variant code, optical-depth family
        p, i64, p, p, p, i64, p, p, i32,  # state, n, cell, flags, table, ncell, block_act, out, seed
        *[f32] * 6,  # domain
        *[f32] * 6, i32, i32,  # lo0, d0, lo1, d1, lo2, d2, n1, n2
        i32, i32, i32, i32, i32,  # stokes_on, inner_rounds, el_iters, kn_iters, block_lanes
        f32, f32, f32, f32, f32,  # kb_over_mec2, thom, c_light, inv_c, inv_mp
        i32, ctypes.POINTER(f32), i32,  # cheb_base, NtConsts floats (host), their count
        p, p,  # aux planes (device, or NULL), stream
    ]
    lib.mcrat_fused_rounds.restype = ctypes.c_int
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
