"""Analytic outflow models (port of ``mcrat_tpu.models.analytic``).

Host-side numpy re-design of Src/analytic_outflows.c.  In the reference these are
in-place overwrites of a *loaded* hydro frame, so even validation runs need
real simulation files; here synthetic rectilinear grids are first-class, so the
full pipeline runs with no data files at all (SURVEY.md section 4 item 1).

All three models keep the reference's hard-coded parameter values as defaults
so results are directly comparable.
"""
from __future__ import annotations

import numpy as np

from ..config import Config, Dims, Geometry, SimType
from ..constants import A_RAD, C_LIGHT, M_P

from ..grid import HydroFrameHost, frame_from_numpy


def make_grid_2d(cfg: Config, r0_edges, r1_edges) -> dict:
    """Rectilinear 2-D grid arrays (C-order raveled meshgrid) for synthetic frames."""
    rc0 = 0.5 * (r0_edges[:-1] + r0_edges[1:])
    rc1 = 0.5 * (r1_edges[:-1] + r1_edges[1:])
    R0, R1 = np.meshgrid(rc0, rc1, indexing="ij")
    D0 = np.broadcast_to(np.diff(r0_edges)[:, None], R0.shape)
    D1 = np.broadcast_to(np.diff(r1_edges)[None, :], R1.shape)
    n = R0.size
    return dict(
        r0=R0.ravel(),
        r1=R1.ravel(),
        dr0=D0.ravel(),
        dr1=D1.ravel(),
        v0=np.zeros(n),
        v1=np.zeros(n),
        dens=np.ones(n),
        pres=np.ones(n),
    )


def amr_blocks_2d(bands, r1_lo: float, r1_hi: float):
    """FLASH-style leaf blocks tiling a 2-D domain in refinement bands.

    ``bands`` lists ``(r0_lo, r0_hi, n0, n1)``: the strip r0_lo <= r0 <
    r0_hi over [r1_lo, r1_hi] cut into n0 x n1 blocks of equal size, each
    block 8 x 8 cells (``io.flash.cells_from_blocks``).  Returns (coords,
    block_size), (nblk, 2) block centres and extents, blocks in band order,
    r1 fastest within a band."""
    coords, sizes = [], []
    for r0_lo, r0_hi, n0, n1 in bands:
        b0, b1 = (r0_hi - r0_lo) / n0, (r1_hi - r1_lo) / n1
        c0 = r0_lo + (np.arange(n0) + 0.5) * b0
        c1 = r1_lo + (np.arange(n1) + 0.5) * b1
        g0, g1 = np.meshgrid(c0, c1, indexing="ij")
        coords.append(np.stack([g0.ravel(), g1.ravel()], axis=-1))
        sizes.append(np.tile([b0, b1], (n0 * n1, 1)))
    return np.concatenate(coords), np.concatenate(sizes)


def cylindrical_prep(host: HydroFrameHost, gamma_infinity=100.0, t_comov=1e5, ddensity=3e-7):
    """Cylindrical outflow overwrite (reference: Src/analytic_outflows.c:7-68).

    Constant Gamma=100 flow parallel to the jet axis with T'=1e5 K and
    rho'=3e-7 g/cm^3; pressure a T'^4 / 3.
    """
    cfg = host.cfg
    n = host.num_elements
    vel = np.sqrt(1.0 - gamma_infinity**-2)
    host.gamma = np.full(n, gamma_infinity)
    host.dens = np.full(n, ddensity)
    host.dens_lab = np.full(n, gamma_infinity * ddensity)
    host.pres = np.full(n, A_RAD * t_comov**4 / 3.0)
    host.temp = np.full(n, t_comov)
    if cfg.geometry in (Geometry.CARTESIAN, Geometry.CYLINDRICAL) and cfg.dims is not Dims.THREE:
        host.v0 = np.zeros(n)
        host.v1 = np.full(n, vel)
    elif cfg.geometry is Geometry.SPHERICAL:
        host.v0 = vel * np.cos(host.r1)
        host.v1 = -vel * np.sin(host.r1)
    elif cfg.geometry is Geometry.CARTESIAN:  # 3-D
        host.v0 = np.zeros(n)
        host.v1 = np.zeros(n)
        host.v2 = np.full(n, vel)
    elif cfg.geometry is Geometry.POLAR:
        host.v0 = np.zeros(n)
        host.v1 = np.zeros(n)
        host.v2 = np.full(n, vel)
    if cfg.dims is Dims.TWO_POINT_FIVE:
        host.v2 = np.zeros(n)
    return host


def spherical_prep(host: HydroFrameHost, gamma_infinity=100.0, lumi=1e54, r00=1e8):
    """Spherical fireball overwrite (reference: Src/analytic_outflows.c:70-145).

    Acceleration phase (r < r00*Gamma_inf): Gamma = r/r00, p ~ r^-4;
    coasting phase: Gamma = Gamma_inf, p ~ r^(-8/3).
    """
    cfg = host.cfg
    r = host.r
    coasting = r >= r00 * gamma_infinity
    # clamp the acceleration branch at gamma = 1: the reference's gamma = r/r00
    # goes below 1 for r < r00 and its vel = sqrt(1 - gamma^-2) then NaNs
    # (Src/analytic_outflows.c:89,97); photons are never injected there, but a
    # finite profile keeps the whole grid transport-safe.
    gamma = np.where(coasting, gamma_infinity, np.maximum(r / r00, 1.0 + 1e-12))
    pres = np.where(
        coasting,
        lumi * r00 ** (2.0 / 3.0) * r ** (-8.0 / 3.0)
        / (12.0 * np.pi * C_LIGHT * gamma_infinity ** (4.0 / 3.0)),
        lumi * r00**2 / (12.0 * np.pi * C_LIGHT * r**4),
    )
    host.gamma = gamma
    host.pres = pres
    host.dens = lumi / (4.0 * np.pi * r**2 * C_LIGHT**3 * gamma_infinity * gamma)
    host.dens_lab = host.dens * gamma
    host.temp = (3.0 * pres / A_RAD) ** 0.25
    vel = np.sqrt(1.0 - gamma**-2.0)
    _radial_velocity(host, vel)
    return host


def structured_fireball_prep(
    host: HydroFrameHost, gamma_0=100.0, lumi=1e52, r00=1e8, theta_j=1e-2, p=4.0
):
    """Lundman, Peer & Ryde (2014) structured jet (reference: Src/analytic_outflows.c:147-236).

    eta(theta) = Gamma_0 / sqrt(1 + (theta/theta_j)^(2p)), floored to 2 outside
    the shear layer; saturation radius r_sat = eta r00; T ~ (r_sat/r)^(2/3)/eta
    beyond saturation.
    """
    cfg = host.cfg
    t0 = (lumi / (4.0 * np.pi * r00**2 * A_RAD * C_LIGHT)) ** 0.25
    theta_ratio = host.theta / theta_j
    eta = gamma_0 / np.sqrt(1.0 + theta_ratio ** (2.0 * p))
    eta = np.where(host.theta >= theta_j * (gamma_0 / 2.0) ** (1.0 / p), 2.0, eta)
    r_sat = eta * r00
    saturated = host.r >= r_sat
    # same gamma >= 1 clamp as spherical_prep (reference NaNs below r_sat/r00)
    gamma = np.where(saturated, eta, np.maximum(host.r / r_sat, 1.0 + 1e-12))
    temp = np.where(saturated, t0 * (r_sat / host.r) ** (2.0 / 3.0) / eta, t0)
    host.gamma = gamma
    host.temp = temp
    vel = np.sqrt(1.0 - gamma**-2.0)
    host.dens = M_P * lumi / (
        4.0 * np.pi * M_P * C_LIGHT**3 * eta * vel * gamma * host.r**2
    )
    host.dens_lab = host.dens * gamma
    host.pres = A_RAD * temp**4 / 3.0
    _radial_velocity(host, vel)
    return host


def _radial_velocity(host: HydroFrameHost, vel):
    """Write a radially-directed velocity field of magnitude ``vel``.

    Covers the geometry dispatch repeated in all three reference preps
    (e.g. Src/analytic_outflows.c:99-140).
    """
    cfg = host.cfg
    g, d = cfg.geometry, cfg.dims
    if g is Geometry.SPHERICAL:
        host.v0 = np.asarray(vel) * np.ones_like(host.r0)
        host.v1 = np.zeros_like(host.r0)
        if d is not Dims.TWO:
            host.v2 = np.zeros_like(host.r0)
    elif d is not Dims.THREE:  # 2-D cartesian / cylindrical
        rr = np.sqrt(host.r0**2 + host.r1**2)
        host.v0 = vel * host.r0 / rr
        host.v1 = vel * host.r1 / rr
        if d is Dims.TWO_POINT_FIVE:
            host.v2 = np.zeros_like(host.r0)
    elif g is Geometry.CARTESIAN:
        rr = np.sqrt(host.r0**2 + host.r1**2 + host.r2**2)
        host.v0 = vel * host.r0 / rr
        host.v1 = vel * host.r1 / rr
        host.v2 = vel * host.r2 / rr
    elif g is Geometry.POLAR:
        rr = np.sqrt(host.r0**2 + host.r2**2)
        host.v0 = vel * host.r0 / rr
        host.v1 = np.zeros_like(host.r0)
        host.v2 = vel * host.r2 / rr


PREPS = {
    SimType.CYLINDRICAL_OUTFLOW: cylindrical_prep,
    SimType.SPHERICAL_OUTFLOW: spherical_prep,
    SimType.STRUCTURED_SPHERICAL_OUTFLOW: structured_fireball_prep,
}


def apply_simulation_type(host: HydroFrameHost) -> HydroFrameHost:
    """Dispatch the analytic overwrite per config (reference: Src/mcrat_io.c:1969-1975)."""
    prep = PREPS.get(host.cfg.simulation_type)
    if prep is not None:
        prep(host)
    return host


def synthetic_spherical_frame(
    cfg: Config,
    r_min: float,
    r_max: float,
    nr: int = 256,
    ntheta: int = 128,
    theta_max: float = np.pi / 2,
    log_r: bool = True,
):
    """Build a synthetic 2-D spherical frame + its rectilinear edges.

    New capability relative to the reference: validation problems run with no
    hydro files (the reference must load a FLASH/PLUTO frame and overwrite it).
    Returns (HydroFrameHost, (r_edges, theta_edges)).
    """
    assert cfg.geometry is Geometry.SPHERICAL and cfg.dims is not Dims.THREE
    if log_r:
        r_edges = np.geomspace(r_min, r_max, nr + 1)
    else:
        r_edges = np.linspace(r_min, r_max, nr + 1)
    t_edges = np.linspace(0.0, theta_max, ntheta + 1)
    arrays = make_grid_2d(cfg, r_edges, t_edges)
    host = frame_from_numpy(cfg, arrays)
    apply_simulation_type(host)
    return host, (r_edges, t_edges)
