"""The spatial index of a loaded frame (port of ``mcrat_tpu.io.hydro.
build_index``)."""
from __future__ import annotations

from typing import Optional, Tuple

from ..config import Config
from ..grid import HydroFrameHost, build_binned_index, build_rectilinear_index, torch_dtype


def build_index(cfg: Config, host: HydroFrameHost, edges: Optional[Tuple] = None,
                device=None):
    """The index of a frame on ``device`` (default: the card): rectilinear
    (exact) when the caller knows the grid edges (synthetic grids, full
    PLUTO grids), else the uniform-bin CSR index over the cell list (AMR
    readers: FLASH, PLUTO-Chombo)."""
    if edges is not None:
        return build_rectilinear_index(*edges, dtype=torch_dtype(cfg), device=device)
    return build_binned_index(host, device=device)
