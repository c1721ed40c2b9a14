"""The cylindrical outflow on FLASH-layout AMR leaf blocks with hot cross
sections and power-law electrons: the program's set-up, the plain reference
and the kernel's least time.

The set-up is ``amr_jet``'s blocks and outflow (``models.analytic.
amr_blocks_2d``, ``io.flash.cells_from_blocks``, Src/mclib_flash.c:60;
Src/analytic_outflows.c:7-68) with ``cyl2_nt``'s physics over them: T' =
5e8 K after the preparation, TABLE optical depth (Src/hot_x_section.c) and a
power law of nonthermal electrons whose density follows the equipartition
field (``ops.cyclosynch.nonthermal_electron_dens``, Src/electron.c:677-706),
the code of both configurations' ``build_host`` copied here.  The frame has
no edges: the program indexes it with a uniform-bin cell list, runs the
carried lookup and, in TABLE mode on a cell list, the per-lane aux planes
(``transport.aux_planes``) and ``packed_cyl2+aux+nt``.
"""
import numpy as np

from benchmark import roofline
from benchmark.reference import amr_table as reference  # noqa: F401 (read by the kind)

# rows of the cell table a window's physics reads for a cell a lane holds:
# the 8 packed rows the AUX_NT kernel reads (chip_smoke.py
# table_rows_read("packed_cyl2", TAU_AUX_NT), :549-568: gamma, the
# temperature, v0, v1, the centre and size) and the 2 the rate reads (the
# density and the nonthermal density), wherever the rate is computed
ROWS_PER_CELL = 10

# FP32 operations of one TABLE rate evaluation at a photon's comoving
# energy, the cell's quantities (its theta's row of the table, n_e sigma_T,
# n_nt f_1 sigma_T) taken as given: log10 eps' 2; the energy axis's index
# and fraction 5 (offset and scale, clamp, floor, fraction); the thermal
# bilinear in log sigma 10 and 10^x 2; each of the three subgroups' linear
# in log sigma 3 and 10^x 2; the biased total 4 (tau0, tau_1, tau0 + 3
# tau_norm) and the thermal probability 1
TABLE_RATE_OPS = 2 + 5 + 10 + 2 + 3 * 5 + 4 + 1
# chip_smoke.py's counts (:480-530) of one Maxwell-Juttner trial, as
# cyl2_nt's
OPS = dict(roofline.OPS, mj_trial=27, table_rate=TABLE_RATE_OPS)
CALLS = dict(roofline.CALLS, mj_trial=dict(log=1, sqrt=1),
             table_rate=dict(log=1, exp=4, div=1))


def build_host(spec: dict):
    """(the program's Config, its host frame, None: a cell list)."""
    from mcrat_tpu_torch import (Config, Dims, Geometry, NonthermalDist, SimType,
                                 TauCalculation)
    from mcrat_tpu_torch.io.flash import cells_from_blocks
    from mcrat_tpu_torch.models.analytic import amr_blocks_2d, cylindrical_prep
    from mcrat_tpu_torch.ops.cyclosynch import nonthermal_electron_dens

    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype=spec["dtype"],
                 stokes=spec["stokes"], max_rounds_per_frame=spec["max_rounds_per_frame"],
                 tau_calculation=TauCalculation[spec["tau_calculation"]],
                 nonthermal_e_dist=NonthermalDist[spec["nonthermal_e_dist"]],
                 powerlaw_index=spec["powerlaw_index"], gamma_min=spec["gamma_min"],
                 gamma_max=spec["gamma_max"], n_gamma=spec["n_gamma"],
                 epsilon_b=spec["epsilon_b"])
    blocks = spec["blocks"]
    coords, size = amr_blocks_2d([tuple(b) for b in blocks["bands"]], blocks["r1_lo"],
                                 blocks["r1_hi"])
    ones = np.ones((len(coords), 64))
    host = cells_from_blocks(cfg, coords, size,
                             dict(velx=0 * ones, vely=0 * ones, dens=ones, pres=ones))
    cylindrical_prep(host, **spec["outflow"])
    host.temp[:] = spec["t_comov_set"]
    host.nonthermal_dens = nonthermal_electron_dens(cfg, host)
    return cfg, host, None


def frame_units(n_photons: int, n_scatt: int) -> dict:
    """The units of work a window needs (``roofline``'s rule: a round for
    each scattering and one more a photon, and on each scattering one
    accepted attempt, scatter and theta and phi trial), with Stokes, and the
    physics of this configuration counted once whatever computes it: one
    TABLE rate evaluation (the thermal bilinear sigma_hat, the three
    subgroups, the biased total) for each photon and each scattering, as
    the rate changes only where the comoving energy does; on each
    scattering one Maxwell-Juttner trial (T' = 5e8 K, past the
    Maxwell-Boltzmann switch), the cheaper of the two populations' draws, as
    ``cyl2_nt`` counts it."""
    units = roofline.frame_units(n_photons, n_scatt, True)
    del units["mb"]
    units.update(table_rate=n_photons + n_scatt, mj_trial=n_scatt)
    return units


def least_time(spec: dict, n_photons: int, n_scatt: int, n_cells: int) -> tuple:
    """(seconds, pipe): the fused-round kernel's least time for a window
    of ``n_photons`` with ``n_scatt`` scatterings over ``n_cells`` cells
    (``roofline.least_time``)."""
    return roofline.least_time(frame_units(n_photons, n_scatt),
                               roofline.frame_bytes(n_photons, n_cells, ROWS_PER_CELL),
                               roofline.OPS_GEO_CYL2, roofline.CALLS_GEO_CYL2, ops=OPS,
                               calls=CALLS)
