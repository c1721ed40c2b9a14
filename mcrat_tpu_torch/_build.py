"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface under ``build/mcrat_tpu_torch/``
of the repository (git-ignored), named by a hash of its source and flags, and
loaded with ``ctypes``.  The build runs at first use; a process reuses the
loaded library.  Nothing here runs at import time.
"""
from __future__ import annotations

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
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
]

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


def build(src: Path = FUSED_ROUND_SRC) -> dict:
    """Compile ``src`` unless its library exists.  Returns a dict with the
    library ``path``, whether it was ``built`` now, the build ``seconds``
    and the compiler's ``log`` (ptxas register/spill report)."""
    text = src.read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    if lib.exists():
        return dict(path=lib, built=False, seconds=0.0, log="")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return dict(path=lib, built=True, seconds=time.perf_counter() - t0,
                log=proc.stdout + proc.stderr)


def load_fused_round() -> ctypes.CDLL:
    """The fused-round kernel library, built on first use."""
    if "fused_round" not in _loaded:
        lib = ctypes.CDLL(str(build(FUSED_ROUND_SRC)["path"]))
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
        _loaded["fused_round"] = lib
    return _loaded["fused_round"]
