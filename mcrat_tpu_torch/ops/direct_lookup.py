"""The rectilinear direct lookup on the card: ``grid.find_cell_direct`` on
CUDA tensors as one launch of ``csrc/direct_lookup.cu``.

:func:`direct_lookup` gives the cells and in-grid flags of
``grid.find_cell_direct_reference`` (the plain version, torch ops) bit for
bit; :func:`direct_lookup_flags` gives, from the same launch, the lane
inputs of one fused-round call on the direct branch: the cells, the cells
clamped to a valid index and the ``FLAG_*`` word of ``transport.lane_flags``.
Each is one launch on the current stream, with no host sync and no
temporaries beyond its outputs.  They adapt to what the call brings: the
configuration's dims and geometry, the index's uniform axes and dtype, and
the positions' dtype (float32 or float64) and strides.
``direct_lookup.launches`` counts the launches of both.
"""
from __future__ import annotations

import torch

from ..config import Dims, Geometry

_DTYPES = (torch.float32, torch.float64)
# csrc/direct_lookup.cu's Geo
_GEO_2D = {Geometry.CARTESIAN: 0, Geometry.CYLINDRICAL: 0, Geometry.SPHERICAL: 1}
_GEO_3D = {Geometry.CARTESIAN: 2, Geometry.SPHERICAL: 3, Geometry.POLAR: 4}


def _geometry_code(cfg) -> int:
    table = _GEO_3D if cfg.dims is Dims.THREE else _GEO_2D
    if cfg.geometry not in table:
        raise ValueError(f"unsupported {cfg.dims.name} geometry {cfg.geometry}")
    return table[cfg.geometry]


def _launch(cfg, index, frame, pos, cell, in_grid=None, alive=None, pool=None, safe=None,
            flags=None, bits=(0, 0, 0)):
    """Check the inputs and launch the kernel into ``cell`` and ``in_grid``,
    or, without ``in_grid``, into ``cell``, ``safe`` and ``flags`` from the
    masks ``alive`` and ``pool`` and the flag ``bits``."""
    if pos.device.type != "cuda":
        raise ValueError(f"direct_lookup runs on cuda tensors, not {pos.device}")
    if pos.dim() != 2 or pos.shape[1] != 3 or pos.dtype not in _DTYPES:
        raise ValueError(f"direct_lookup takes (N, 3) float32 or float64 positions, not "
                         f"{tuple(pos.shape)} {pos.dtype}")
    n = pos.shape[0]
    for mask in (alive, pool):
        if mask is not None and (mask.shape != (n,) or mask.dtype != torch.bool
                                 or mask.device != pos.device or not mask.is_contiguous()):
            raise ValueError(f"direct_lookup_flags takes contiguous ({n},) bool alive and pool "
                             f"masks on {pos.device}")
    geometry = _geometry_code(cfg)
    if n == 0:
        return
    from .._build import load_direct_lookup

    lib = load_direct_lookup()
    params, edges = index.lookup_tables(frame, pos.dtype)
    if params.device != pos.device or edges[0].device != pos.device:
        raise ValueError(f"direct_lookup takes an index and a frame on {pos.device}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(pos.device):
        err = lib.mcrat_direct_lookup(
            geometry, int(pos.dtype == torch.float64), int(edges[0].dtype == torch.float64),
            pos.data_ptr(), pos.stride(0), pos.stride(1), n, params.data_ptr(),
            *(e.data_ptr() for e in edges), *index.shape,
            sum(int(u) << a for a, u in enumerate(index.uniform)), int(index.three_d),
            cell.data_ptr(), ptr(in_grid), ptr(alive), ptr(pool), ptr(safe), ptr(flags),
            frame.num_elements, *bits, torch.cuda.current_stream(pos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"direct_lookup kernel launch failed: "
                           f"{lib.mcrat_direct_lookup_error_string(err).decode()}")
    direct_lookup.launches += 1


def direct_lookup(cfg, index, frame, pos):
    """Containing cell (int32, -1 outside the grid) and in-grid flag (bool)
    of the (N, 3) MCRaT positions ``pos`` (a CUDA tensor of float32 or
    float64, any strides) on ``frame`` through ``index`` (a
    ``grid.RectilinearIndex`` on the same card): one launch, none for an
    empty lane set.  Raises on tensors elsewhere than on a CUDA device, on
    another dtype, on a geometry ``geometry.mcrat_to_hydro`` does not take,
    and if the launch fails."""
    n = pos.shape[0]
    cell = torch.empty(n, dtype=torch.int32, device=pos.device)
    in_grid = torch.empty(n, dtype=torch.bool, device=pos.device)
    _launch(cfg, index, frame, pos, cell, in_grid=in_grid)
    return cell, in_grid


def direct_lookup_flags(cfg, index, frame, pos, alive, pool, bits):
    """:func:`direct_lookup` with the fused-round call's lane inputs in the
    same launch: (cell, safe, flags), ``safe`` the cell clamped to [0,
    n_cell - 1] (int32) and ``flags`` (int32) ``alive * bits[0] + pool *
    bits[1] + in_grid * bits[2]`` of the (N,) bool masks ``alive`` and
    ``pool``."""
    n = pos.shape[0]
    cell, safe, flags = (torch.empty(n, dtype=torch.int32, device=pos.device) for _ in range(3))
    _launch(cfg, index, frame, pos, cell, alive=alive, pool=pool, safe=safe, flags=flags,
            bits=bits)
    return cell, safe, flags


direct_lookup.launches = 0
