"""The carried AMR search on the card: ``grid.BinnedIndex.find`` on CUDA
tensors as one launch of ``csrc/binned_search.cu``.

:func:`binned_search` gives the cells of ``BinnedIndex.find_reference`` (the
plain version, torch ops in lane chunks) bit for bit, in one launch on the
current stream, with no host sync and no temporaries beyond its int32
output.  It adapts to what the call brings: the lanes' dtype (float32 or
float64) and the frame's, and whether the index has more than one bin along
axis 2.  ``binned_search.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPES = (torch.float32, torch.float64)


def binned_search(index, r0, r1, r2, frame) -> torch.Tensor:
    """Containing cell (int32, -1 where no cell holds the point) of the 1-D
    hydro coordinates ``r0``, ``r1``, ``r2`` (CUDA tensors of one dtype and
    length) on ``frame``, through ``index`` (a ``grid.BinnedIndex`` on the
    same card): one launch, none for an empty lane set.  Raises on tensors
    elsewhere than on a CUDA device, on another dtype than float32 or
    float64, and if the launch fails."""
    if r0.device.type != "cuda":
        raise ValueError(f"binned_search runs on cuda tensors, not {r0.device}")
    if r0.dim() != 1 or any(r.shape != r0.shape or r.dtype != r0.dtype for r in (r1, r2)):
        raise ValueError("binned_search takes three 1-D coordinate tensors of one shape "
                         "and dtype")
    if r0.dtype not in _DTYPES or frame.r0.dtype not in _DTYPES:
        raise ValueError(f"binned_search takes float32 or float64 coordinates and frames, "
                         f"not {r0.dtype} on a {frame.r0.dtype} frame")
    n = r0.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=r0.device)
    if n == 0:
        return out
    from .._build import load_binned_search

    lib = load_binned_search()
    three_d = index.dims[2] > 1
    rows, lo, inv = index.search_tables(frame, r0.dtype)
    r0, r1, r2 = (r.contiguous() for r in (r0, r1, r2))
    with torch.cuda.device(r0.device):
        err = lib.mcrat_binned_search(
            int(r0.dtype == torch.float64), int(rows.dtype == torch.float64), int(three_d),
            r0.data_ptr(), r1.data_ptr(), r2.data_ptr(), ctypes.c_int64(n),
            index.cell_ids.data_ptr(), index.bin_start.data_ptr(), index.bin_count.data_ptr(),
            rows.data_ptr(), lo.data_ptr(), inv.data_ptr(), *index.dims, index.max_slab,
            out.data_ptr(), torch.cuda.current_stream(r0.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"binned_search kernel launch failed: "
                           f"{lib.mcrat_binned_search_error_string(err).decode()}")
    binned_search.launches += 1
    return out


binned_search.launches = 0
