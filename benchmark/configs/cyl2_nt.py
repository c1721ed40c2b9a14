"""The cylindrical outflow with hot cross sections and power-law electrons on
a uniform 2-D grid: the program's set-up, the plain reference and the
kernel's least time.

Rewritten from ``chip_smoke.py`` ``problem()`` (:352-460, its ("flagship",
"nt") main path), calling only the program's set-up entry points: the
``cyl2_jet`` grid and outflow (Src/analytic_outflows.c:7-68) at T' = 5e8 K,
TABLE optical depth (Src/hot_x_section.c) and a power law of nonthermal
electrons whose density follows the equipartition field
(``ops.cyclosynch.nonthermal_electron_dens``, Src/electron.c:677-706).
Nonthermal electrons read the packed table, so the program runs
``packed_cyl2+cheb+nt`` on the rectilinear grid.
"""
import numpy as np

from benchmark import roofline
from benchmark.reference import table as reference  # noqa: F401 (read by the kind)

# rows of the cell table the kernel reads for a cell a lane holds
# (chip_smoke.py table_rows_read("packed_cyl2", TAU_CHEB_NT), :549-568): of
# the packed rows gamma, the temperature, v0, v1, the density, the
# nonthermal density and the centre and size; the 16 Chebyshev rows
ROWS_PER_CELL = 26

# chip_smoke.py's counts (:480-530) of the units this physics adds to
# roofline.OPS / CALLS: one Maxwell-Juttner trial and the CHEB_NT rate (two
# Chebyshev sigmas, the biased total)
OPS = dict(roofline.OPS, mj_trial=27, cheb_nt=53)
CALLS = dict(roofline.CALLS, mj_trial=dict(log=1, sqrt=1), cheb_nt=dict(exp=2, div=1))


def build_host(spec: dict):
    """(the program's Config, its host frame, the grid's (r0, r1) edges)."""
    from mcrat_tpu_torch import (Config, Dims, Geometry, NonthermalDist, SimType,
                                 TauCalculation)
    from mcrat_tpu_torch.grid import frame_from_numpy
    from mcrat_tpu_torch.models.analytic import cylindrical_prep, make_grid_2d
    from mcrat_tpu_torch.ops.cyclosynch import nonthermal_electron_dens

    cfg = Config(dims=Dims.TWO, geometry=Geometry.CYLINDRICAL,
                 simulation_type=SimType.CYLINDRICAL_OUTFLOW, dtype=spec["dtype"],
                 stokes=spec["stokes"], max_rounds_per_frame=spec["max_rounds_per_frame"],
                 tau_calculation=TauCalculation[spec["tau_calculation"]],
                 nonthermal_e_dist=NonthermalDist[spec["nonthermal_e_dist"]],
                 powerlaw_index=spec["powerlaw_index"], gamma_min=spec["gamma_min"],
                 gamma_max=spec["gamma_max"], n_gamma=spec["n_gamma"],
                 epsilon_b=spec["epsilon_b"])
    edges = tuple(np.linspace(*spec["grid"][axis]) for axis in ("r0", "r1"))
    host = frame_from_numpy(cfg, make_grid_2d(cfg, *edges))
    cylindrical_prep(host, **spec["outflow"])
    host.temp[:] = spec["t_comov_set"]
    host.nonthermal_dens = nonthermal_electron_dens(cfg, host)
    return cfg, host, edges


def frame_units(n_photons: int, n_scatt: int) -> dict:
    """The units of work a window needs (``roofline``'s rule: a round for
    each scattering and one more a photon, and on each scattering one
    accepted attempt, scatter and theta and phi trial), with Stokes: every
    round evaluates the CHEB_NT rate; a scattering draws its electron from
    one population, thermal (one Maxwell-Juttner trial at T' = 5e8 K, past
    the Maxwell-Boltzmann switch) or nonthermal (``nt_draw``), and which one
    is not known from the photons, so each takes the cheaper, the
    Maxwell-Juttner trial (58 FP32 operations and one SFU instruction,
    against chip_smoke.py's ``nt_draw``, 97 and five)."""
    units = roofline.frame_units(n_photons, n_scatt, True)
    del units["mb"]
    units.update(cheb_nt=units["lane_round"], mj_trial=n_scatt)
    return units


def least_time(spec: dict, n_photons: int, n_scatt: int, n_cells: int) -> tuple:
    """(seconds, pipe): the fused-round kernel's least time for a window
    of ``n_photons`` with ``n_scatt`` scatterings over ``n_cells`` cells
    (``roofline.least_time``)."""
    return roofline.least_time(frame_units(n_photons, n_scatt),
                               roofline.frame_bytes(n_photons, n_cells, ROWS_PER_CELL),
                               roofline.OPS_GEO_CYL2, roofline.CALLS_GEO_CYL2, ops=OPS,
                               calls=CALLS)
