"""The carried AMR lookup on the card, as launches of ``csrc/binned_search.cu``.

:func:`carried_lookup` is ``grid.find_cell_rows`` on CUDA tensors, the
cached-cell pin with the search of the lanes that left their cell, and
:func:`carried_lookup_flags` the same with a fused-round call's lane inputs
(the cells, the cells clamped to a valid index and the ``FLAG_*`` word of
``transport.lane_flags``): the values of ``grid.find_cell_rows_reference``
(the plain version, torch ops with ``BinnedIndex.find``) bit for bit.  Each
is one launch on the current stream, with no host sync and no temporaries
beyond its outputs.  They adapt to what the call brings: the lanes' dtype
(float32 or float64) and strides, the frame's dtype, the configuration's
geometry and whether the index has more than one bin along axis 2.
``carried_lookup.launches`` counts their launches.
"""
from __future__ import annotations

import ctypes

import torch

from .direct_lookup import _geometry_code

_DTYPES = (torch.float32, torch.float64)


def _pin_columns(frame) -> tuple:
    """The frame's r0, r1, r2, dr0, dr1, dr2: the pin reads the cached
    cell's centre and size from them (axis 2 in 3-D only)."""
    cols = (frame.r0, frame.r1, frame.r2, frame.dr0, frame.dr1, frame.dr2)
    if any(c.dtype != frame.r0.dtype or not c.is_contiguous() or c.shape != frame.r0.shape
           for c in cols):
        raise ValueError("the carried lookup takes a frame whose geometry columns are "
                         "contiguous, of one length and one dtype")
    return cols


def _carried(cfg, index, frame, pos, cached, cell, in_grid=None, alive=None, pool=None,
             safe=None, flags=None, bits=(0, 0, 0), searched=None) -> None:
    """Check the inputs and launch the carried lookup into ``cell`` and
    ``in_grid``, or, without ``in_grid``, into ``cell``, ``safe`` and
    ``flags`` from the masks ``alive`` and ``pool`` and the flag ``bits``;
    ``searched`` (an int64 on the card, or None) gains the lanes searched."""
    if pos.dim() != 2 or pos.shape[1] != 3 or pos.dtype not in _DTYPES:
        raise ValueError(f"carried_lookup takes (N, 3) float32 or float64 positions, not "
                         f"{tuple(pos.shape)} {pos.dtype}")
    n = pos.shape[0]
    if (cached.shape != (n,) or cached.dtype != torch.int32 or cached.device != pos.device
            or not cached.is_contiguous()):
        raise ValueError(f"carried_lookup takes contiguous ({n},) int32 cached cells on "
                         f"{pos.device}")
    for mask in (alive, pool):
        if mask is not None and (mask.shape != (n,) or mask.dtype != torch.bool
                                 or mask.device != pos.device or not mask.is_contiguous()):
            raise ValueError(f"carried_lookup_flags takes contiguous ({n},) bool alive and "
                             f"pool masks on {pos.device}")
    if searched is not None and (searched.numel() != 1 or searched.dtype != torch.int64
                                 or searched.device != pos.device):
        raise ValueError(f"carried_lookup takes an int64 counter on {pos.device}")
    if frame.r0.dtype not in _DTYPES:
        raise ValueError(f"carried_lookup takes a float32 or float64 frame, not "
                         f"{frame.r0.dtype}")
    if pos.device.type != "cuda":
        raise ValueError(f"carried_lookup runs on cuda tensors, not {pos.device}")
    geometry = _geometry_code(cfg)
    cols = _pin_columns(frame)
    if n == 0:
        return
    from .._build import load_binned_search

    lib = load_binned_search()
    rows, params = index.search_tables(frame, pos.dtype)
    if rows.device != pos.device or cols[0].device != pos.device:
        raise ValueError(f"carried_lookup takes an index and a frame on {pos.device}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(pos.device):
        err = lib.mcrat_carried_lookup(
            geometry, int(pos.dtype == torch.float64), int(cols[0].dtype == torch.float64),
            int(index.dims[2] > 1), pos.data_ptr(), pos.stride(0), pos.stride(1), n,
            cached.data_ptr(), *(c.data_ptr() for c in cols), frame.num_elements,
            params.data_ptr(), index.cell_ids.data_ptr(), index.bin_start.data_ptr(),
            index.bin_count.data_ptr(), rows.data_ptr(), *index.dims, index.max_slab,
            cell.data_ptr(), ptr(in_grid), ptr(alive), ptr(pool), ptr(safe), ptr(flags), *bits,
            ptr(searched), torch.cuda.current_stream(pos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"carried_lookup kernel launch failed: "
                           f"{lib.mcrat_binned_search_error_string(err).decode()}")
    carried_lookup.launches += 1


def carried_lookup(cfg, index, frame, pos, cached, searched=None):
    """Containing cell (int32, -1 outside the domain) and in-grid flag
    (bool) of the (N, 3) MCRaT positions ``pos`` (a CUDA tensor of float32
    or float64, any strides) on ``frame`` through ``index`` (a
    ``grid.BinnedIndex`` on the same card), behind the cached cells
    ``cached`` ((N,) int32): one launch, none for an empty lane set.
    ``searched``, an int64 tensor on the card or None, gains the lanes
    searched.  Raises on tensors elsewhere than on a CUDA device, on another
    dtype, on a geometry ``geometry.mcrat_to_hydro`` does not take, and if
    the launch fails."""
    n = pos.shape[0]
    cell = torch.empty(n, dtype=torch.int32, device=pos.device)
    in_grid = torch.empty(n, dtype=torch.bool, device=pos.device)
    _carried(cfg, index, frame, pos, cached, cell, in_grid=in_grid, searched=searched)
    return cell, in_grid


def carried_lookup_flags(cfg, index, frame, pos, cached, alive, pool, bits, searched=None):
    """:func:`carried_lookup` with the fused-round call's lane inputs in the
    same launch: (cell, safe, flags), ``safe`` the cell clamped to [0,
    n_cell - 1] (int32) and ``flags`` (int32) ``alive * bits[0] + pool *
    bits[1] + in_grid * bits[2]`` of the (N,) bool masks ``alive`` and
    ``pool``."""
    n = pos.shape[0]
    cell, safe, flags = (torch.empty(n, dtype=torch.int32, device=pos.device) for _ in range(3))
    _carried(cfg, index, frame, pos, cached, cell, alive=alive, pool=pool, safe=safe,
             flags=flags, bits=bits, searched=searched)
    return cell, safe, flags


carried_lookup.launches = 0
