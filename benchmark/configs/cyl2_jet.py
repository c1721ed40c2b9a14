"""The cylindrical outflow on a uniform 2-D rectilinear grid: the program's
set-up, the plain reference and the kernel's least time.

Rewritten from ``chip_smoke.py`` ``problem()`` (:352-460, its "flagship"
branch), calling only the program's set-up entry points.  The outflow is
MCRaT's cylindrical test (Src/analytic_outflows.c:7-68, the program's
``models.analytic.cylindrical_prep``): Gamma = 100 along the jet axis,
T' = 1e5 K, rho' = 3e-7 g/cm^3, on 160 x 512 uniform cells (a grid the
configuration assumes: MCRaT's test overwrites a loaded frame's fluid, so
its source fixes no grid).
"""
import numpy as np

from benchmark import roofline
from benchmark.reference import frame as reference  # noqa: F401 (read by the kind)

# rows of the cell table the kernel reads for a cell a lane holds
# (chip_smoke.py table_rows_read, :549-568): the ultra table whole (v0,
# v1, the electron density, the temperature)
ROWS_PER_CELL = 4


def build_host(spec: dict):
    """(the program's Config, its host frame, the grid's (r0, r1) edges)."""
    from mcrat_tpu_torch import Config, Dims, Geometry, SimType
    from mcrat_tpu_torch.grid import frame_from_numpy
    from mcrat_tpu_torch.models.analytic import cylindrical_prep, make_grid_2d

    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype=spec["dtype"],
                 stokes=spec["stokes"], max_rounds_per_frame=spec["max_rounds_per_frame"])
    edges = tuple(np.linspace(*spec["grid"][axis]) for axis in ("r0", "r1"))
    host = frame_from_numpy(cfg, make_grid_2d(cfg, *edges))
    cylindrical_prep(host, **spec["outflow"])
    return cfg, host, edges


def least_time(spec: dict, n_photons: int, n_scatt: int, n_cells: int) -> tuple:
    """(seconds, pipe): the fused-round kernel's least time for a window
    of ``n_photons`` with ``n_scatt`` scatterings over ``n_cells`` cells
    (``roofline.least_time``)."""
    return roofline.least_time(roofline.frame_units(n_photons, n_scatt, spec["stokes"]),
                               roofline.frame_bytes(n_photons, n_cells, ROWS_PER_CELL),
                               roofline.OPS_GEO_CYL2, roofline.CALLS_GEO_CYL2)
