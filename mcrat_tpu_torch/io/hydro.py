"""Hydro frame loading (port of ``mcrat_tpu.io.hydro``).

getHydroData (reference: Src/mcrat_io.c:1898-1990): builds the frame file
name, dispatches on the hydro format, applies the analytic test-problem
overwrite and the nonthermal electron densities, and builds the spatial
index of the loaded frame on the device.  Every format the JAX package
reads: SYNTHETIC, FLASH, PLUTO (``.dbl``, or ``.h5`` through h5py),
PLUTO-Chombo (h5py) and RIKEN (2-D and 3-D).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..config import Config, Dims, HydroSim, NonthermalDist, SimType
from ..grid import HydroFrameHost, build_binned_index, build_rectilinear_index, torch_dtype
from ..models.analytic import apply_simulation_type
from . import flash, pluto, pluto_chombo, riken


@dataclasses.dataclass
class HydroPaths:
    """File-system layout of the hydro simulation (reference: FILEPATH /
    FILEROOT / MC_PATH macros, Src/mcrat_input.h)."""

    filepath: str = "./"
    fileroot: str = ""
    mc_path: str = "MC/"


def frame_filename(cfg: Config, paths: HydroPaths, frame: int) -> str:
    """The file of a frame (RIKEN: the prefix the reader completes per
    variable)."""
    if cfg.sim_switch is HydroSim.FLASH:
        return flash.flash_frame_name(paths.filepath, paths.fileroot, frame)
    if cfg.sim_switch is HydroSim.PLUTO:
        suffix = "." + cfg.pluto_filetype.value
        return paths.filepath + pluto.pluto_frame_name(paths.fileroot, frame, suffix)
    if cfg.sim_switch is HydroSim.PLUTO_CHOMBO:
        return paths.filepath + pluto.pluto_frame_name(paths.fileroot, frame, ".hdf5")
    if cfg.sim_switch is HydroSim.RIKEN:
        return paths.filepath
    raise ValueError(f"no files for {cfg.sim_switch}")


def get_hydro_data(
    cfg: Config,
    paths: HydroPaths,
    frame: int,
    fps: float,
    r_inj: float,
    ph_inj_switch: bool,
    min_r: float = 0.0,
    max_r: float = np.inf,
    min_theta: float = 0.0,
    max_theta: float = np.pi,
    synthetic_frame: Optional[HydroFrameHost] = None,
) -> HydroFrameHost:
    """Load (or take the synthetic) hydro frame, post-process it, and return
    the host frame (``mcrat_tpu.io.hydro.get_hydro_data``).

    ``synthetic_frame`` supplies the grid of HydroSim.SYNTHETIC runs; the
    analytic overwrite still runs on it, as on a loaded frame.
    """
    if cfg.sim_switch is HydroSim.SYNTHETIC:
        if synthetic_frame is None:
            raise ValueError("SYNTHETIC runs need a synthetic_frame")
        host = synthetic_frame
    elif cfg.sim_switch is HydroSim.RIKEN and cfg.dims is Dims.THREE:
        host = riken.read_riken_3d(cfg, paths.filepath, frame, fps, r_inj, ph_inj_switch,
                                   min_r, max_r)
    elif cfg.sim_switch is HydroSim.RIKEN:
        host = riken.read_riken_2d(cfg, paths.filepath, frame, fps, r_inj, ph_inj_switch,
                                   min_r, max_r, min_theta, max_theta)
    else:
        reader = {HydroSim.FLASH: flash.read_flash, HydroSim.PLUTO: pluto.read_pluto,
                  HydroSim.PLUTO_CHOMBO: pluto_chombo.read_pluto_chombo}[cfg.sim_switch]
        host = reader(cfg, frame_filename(cfg, paths, frame), fps, r_inj, ph_inj_switch,
                      min_r, max_r, min_theta, max_theta)

    # analytic test-problem overwrite (reference: Src/mcrat_io.c:1969-1975)
    if cfg.simulation_type is not SimType.SCIENCE:
        apply_simulation_type(host)

    # nonthermal electron densities (reference: Src/mcrat_io.c:1977-1983)
    if cfg.nonthermal_e_dist is not NonthermalDist.OFF:
        from ..ops import cyclosynch

        host.nonthermal_dens = cyclosynch.nonthermal_electron_dens(cfg, host)
    return host


def build_index(cfg: Config, host: HydroFrameHost, edges: Optional[Tuple] = None,
                device=None):
    """The index of a frame on ``device`` (default: the card): rectilinear
    (exact) when the caller knows the grid edges (synthetic grids), else the
    uniform-bin CSR index over the cell list (the readers' decimated frames:
    FLASH, PLUTO, PLUTO-Chombo, RIKEN)."""
    if edges is not None:
        return build_rectilinear_index(*edges, dtype=torch_dtype(cfg), device=device)
    return build_binned_index(host, device=device)
