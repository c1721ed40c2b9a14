"""The spherical fireball on a 2-D spherical grid, log-spaced in r: the
program's set-up, the plain reference and the kernel's least time.

Rewritten from ``chip_smoke.py`` ``problem()`` (:398-405, its "spherical"
branch), calling only the program's set-up entry points.  The outflow is
MCRaT's spherical fireball (SIMULATION_TYPE SPHERICAL_OUTFLOW,
Src/analytic_outflows.c:70-145, the program's
``models.analytic.spherical_prep``): Gamma = r / r0 up to Gamma_inf = 100,
then coasting, L = 1e54 erg/s, r0 = 1e8 cm, on 384 log-spaced radii x 64
theta cells (the default synthetic spherical grid,
``models.analytic.synthetic_spherical_frame``; MCRaT's test overwrites a
loaded frame's fluid, so its source fixes no grid).  The radial axis is not
uniform, so the program indexes it by ``searchsorted`` (the direct lookup's
searched axis) and runs ``packed_sph2``.
"""
from benchmark import roofline
from benchmark.reference import sph2 as reference  # noqa: F401 (read by the kind)

# rows of the cell table the kernel reads for a cell a lane holds
# (chip_smoke.py table_rows_read("packed_sph2", TAU_DIRECT), :549-568): of
# the packed rows gamma, the temperature, v0, v1, the density, the centre
# and size, and the sine and cosine of theta
ROWS_PER_CELL = 11

# chip_smoke.py's counts (OPS_GEO, CALLS_GEO, :501, :529) for a sph2 round:
# the fluid velocity at the photon (theta's rotation of (v_r, v_theta) and
# the photon's azimuth) and the membership test (r, cos theta, the cosine
# space theta test and the domain)
OPS_GEO = (14, 20)
CALLS_GEO = (dict(sqrt=1, div=2), dict(sqrt=2, div=1))


def build_host(spec: dict):
    """(the program's Config, its host frame, the grid's (r, theta) edges)."""
    from mcrat_tpu_torch import Config, Dims, Geometry, SimType
    from mcrat_tpu_torch.models.analytic import spherical_prep, synthetic_spherical_frame

    cfg = Config(dims=Dims.TWO, geometry=Geometry.SPHERICAL,
                 simulation_type=SimType[spec["simulation_type"]], dtype=spec["dtype"],
                 stokes=spec["stokes"], max_rounds_per_frame=spec["max_rounds_per_frame"])
    host, edges = synthetic_spherical_frame(cfg, **spec["grid"])
    # the configured outflow over the one the simulation type applied
    spherical_prep(host, **spec["outflow"])
    return cfg, host, edges


def least_time(spec: dict, n_photons: int, n_scatt: int, n_cells: int) -> tuple:
    """(seconds, pipe): the fused-round kernel's least time for a window
    of ``n_photons`` with ``n_scatt`` scatterings over ``n_cells`` cells
    (``roofline.least_time``)."""
    return roofline.least_time(roofline.frame_units(n_photons, n_scatt, spec["stokes"]),
                               roofline.frame_bytes(n_photons, n_cells, ROWS_PER_CELL),
                               OPS_GEO, CALLS_GEO)
