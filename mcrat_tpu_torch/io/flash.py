"""FLASH 2-D AMR frames (port of ``mcrat_tpu.io.flash``).

readAndDecimate (reference: Src/mclib_flash.c:60-431) in two parts:
:func:`cells_from_blocks` expands leaf blocks into 8x8 cells with the fixed
sub-cell offsets, applies the unit scales and decimates, all vectorized
numpy; :func:`read_flash` reads the block datasets of one HDF5 file (h5py,
imported there) and calls it.  Both return the port's
:class:`~mcrat_tpu_torch.grid.HydroFrameHost`; :func:`mcrat_tpu_torch.io.
hydro.build_index` gives it its :class:`~mcrat_tpu_torch.grid.BinnedIndex`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import Config
from ..grid import HydroFrameHost, frame_from_numpy
from .decimate import decimation_mask

# sub-cell centre offsets within a block, in units of the block size
# (reference: Src/mclib_flash.c:69)
X1 = np.array([-7.0, -5.0, -3.0, -1.0, 1.0, 3.0, 5.0, 7.0]) / 16.0
NB = 8  # cells per block side
FIELDS = ("velx", "vely", "dens", "pres")


def flash_frame_name(filepath: str, fileroot: str, frame: int) -> str:
    """FLASH file naming: FILEPATH + FILEROOT + zero-padded 4-digit frame
    (reference: modifyFlashName, Src/mclib_flash.c:15-58)."""
    return f"{filepath}{fileroot}{frame:04d}"


def cells_from_blocks(cfg: Config, coords, block_size, fields: dict,
                      node_type=None, decimation: Optional[dict] = None) -> HydroFrameHost:
    """The cell list of FLASH blocks (mcrat_tpu/io/flash.py:52-89).

    ``coords`` and ``block_size`` are (nblk, 2) block centres and extents in
    code units; ``fields`` maps velx, vely, dens and pres to (nblk, 64)
    arrays (x index fastest within a block, mclib_flash.c:246-266);
    ``node_type`` (nblk,) keeps the leaf blocks (== 1), all blocks when
    None.  Lengths scale by ``cfg.hydro_l_scale``, densities and pressures
    by ``hydro_d_scale`` and ``hydro_p_scale``.  ``decimation`` holds the
    keyword arguments of :func:`~mcrat_tpu_torch.io.decimate.
    decimation_mask` after the cell columns (fps, r_inj, ph_inj_switch,
    min_r, max_r, min_theta, max_theta); None keeps every cell."""
    coords = np.asarray(coords, dtype=np.float64)
    block_size = np.asarray(block_size, dtype=np.float64)
    nblk = len(coords)
    vals = {k: np.asarray(fields[k], dtype=np.float64).reshape(nblk, -1) for k in FIELDS}
    if node_type is not None:
        leaf = np.asarray(node_type).reshape(nblk, -1)[:, 0] == 1
        coords, block_size = coords[leaf], block_size[leaf]
        vals = {k: v[leaf] for k, v in vals.items()}
    off_x = np.tile(X1, NB)  # x offset, cycles fastest
    off_y = np.repeat(X1, NB)  # y offset, one step per row
    scale = cfg.hydro_l_scale
    cx = (coords[:, 0:1] + block_size[:, 0:1] * off_x[None, :]) * scale
    cy = (coords[:, 1:2] + block_size[:, 1:2] * off_y[None, :]) * scale
    szx = np.broadcast_to(block_size[:, 0:1] / NB * scale, cx.shape)
    szy = np.broadcast_to(block_size[:, 1:2] / NB * scale, cy.shape)
    arr = dict(
        r0=cx.ravel(), r1=cy.ravel(), dr0=szx.ravel(), dr1=szy.ravel(),
        v0=vals["velx"].ravel(), v1=vals["vely"].ravel(),
        dens=vals["dens"].ravel() * cfg.hydro_d_scale,
        pres=vals["pres"].ravel() * cfg.hydro_p_scale,
    )
    if decimation is not None:
        keep = decimation_mask(cfg, arr["r0"], arr["r1"], 0.0, arr["dr0"], arr["dr1"], 0.0,
                               cyclosynchrotron=cfg.cyclosynchrotron, **decimation)
        arr = {k: v[keep] for k, v in arr.items()}
    return frame_from_numpy(cfg, arr)


def read_flash(cfg: Config, path: str, fps: float, r_inj: float, ph_inj_switch: bool,
               min_r: float = 0.0, max_r: float = np.inf, min_theta: float = 0.0,
               max_theta: float = np.pi) -> HydroFrameHost:
    """One FLASH 2-D HDF5 frame (mcrat_tpu.io.flash.read_flash): the leaf
    blocks' cells, unit-scaled and decimated to the photon band."""
    import h5py

    with h5py.File(path, "r") as f:
        coords = np.asarray(f["coordinates"], dtype=np.float64)
        block_size = np.asarray(f["block size"], dtype=np.float64)
        node_type = np.asarray(f["node type"], dtype=np.int64)
        fields = {k: np.asarray(f[k], dtype=np.float64) for k in FIELDS}
    return cells_from_blocks(
        cfg, coords, block_size, fields, node_type=node_type,
        decimation=dict(fps=fps, r_inj=r_inj, ph_inj_switch=ph_inj_switch, min_r=min_r,
                        max_r=max_r, min_theta=min_theta, max_theta=max_theta))
