"""The cylindrical outflow on FLASH-layout AMR leaf blocks: the program's
set-up, the plain reference and the kernel's least time.

Rewritten from ``chip_smoke.py`` ``problem()`` (:352-460, its "amr_cyl2"
branch, and ``AMR_BANDS``), calling only the program's set-up entry
points: leaf blocks of 8 x 8 cells in refinement bands
(``models.analytic.amr_blocks_2d``), turned into the cell list a FLASH
file gives (``io.flash.cells_from_blocks``, Src/mclib_flash.c:60), with
MCRaT's cylindrical outflow (Src/analytic_outflows.c:7-68).  No h5py: the
blocks are built in memory.  The frame has no edges: the program indexes it
with a uniform-bin cell list and runs the carried lookup.
"""
import numpy as np

from benchmark import roofline
from benchmark.reference import frame as reference  # noqa: F401 (read by the kind)

# rows of the cell table the kernel reads for a cell a lane holds
# (chip_smoke.py table_rows_read, :549-568): of the packed rows in DIRECT
# 2-D cyl2, gamma, the temperature, v0, v1, the density and the centre and
# size
ROWS_PER_CELL = 9


def build_host(spec: dict):
    """(the program's Config, its host frame, None: a cell list)."""
    from mcrat_tpu_torch import Config, Dims, Geometry, SimType
    from mcrat_tpu_torch.io.flash import cells_from_blocks
    from mcrat_tpu_torch.models.analytic import amr_blocks_2d, cylindrical_prep

    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype=spec["dtype"],
                 stokes=spec["stokes"], max_rounds_per_frame=spec["max_rounds_per_frame"])
    blocks = spec["blocks"]
    coords, size = amr_blocks_2d([tuple(b) for b in blocks["bands"]], blocks["r1_lo"],
                                 blocks["r1_hi"])
    ones = np.ones((len(coords), 64))
    host = cells_from_blocks(cfg, coords, size,
                             dict(velx=0 * ones, vely=0 * ones, dens=ones, pres=ones))
    cylindrical_prep(host, **spec["outflow"])
    return cfg, host, None


def least_time(spec: dict, n_photons: int, n_scatt: int, n_cells: int) -> tuple:
    """(seconds, pipe): the fused-round kernel's least time for a window
    of ``n_photons`` with ``n_scatt`` scatterings over ``n_cells`` cells
    (``roofline.least_time``)."""
    return roofline.least_time(roofline.frame_units(n_photons, n_scatt, spec["stokes"]),
                               roofline.frame_bytes(n_photons, n_cells, ROWS_PER_CELL),
                               roofline.OPS_GEO_CYL2, roofline.CALLS_GEO_CYL2)
