"""The transport round of a 2-D cylindrical frame, in plain PyTorch.

Frozen copy, cut to what the benchmark's configurations run (2-D
cylindrical geometry, DIRECT (Thomson) optical depth, thermal electrons),
of the plain twin of the fused-round kernel:
``mcrat_tpu_torch/ops/fused_round.py`` ``_boost`` (:317-333),
``_rotate_basis`` (:335-360), ``_thermal_gamma_beta`` (:362-411),
``_electron_from_gamma`` (:413-445), ``_kn_cross_section`` (:447-460),
``_sample_kn_angles`` (:489-545), ``_single_scatter`` (:547-606),
``_phi_components`` (:608-614), ``_Cell`` (:616-763, the ultra and packed
cyl2 rows), ``_rounds`` (:877-1023, without the work tally, the TABLE and
nonthermal branches and the aux planes), ``draw_offsets`` (:198-206) and
``fused_rounds_reference`` (:1071-1113); one change, ``_fano_normalized``,
where the program's float32 division gives NaN.  One call runs ``inner_rounds``
rounds per lane:

    comoving boost -> tau rate -> free path -> move -> electron draw
    -> polarized Klein-Nishina scatter attempt -> Stokes -> cell membership

A lane that leaves its cell stalls until the caller re-resolves its cell.
``dtype`` is the working precision of the state and the arithmetic:
float32 is the configuration's; a lower one is the comparison's control.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import hash as rng
from .constants import C_LIGHT, KB_OVER_MEC2, M_P, THOM_X_SECT

# state plane layout: lab p, position, Stokes q/u/v (I == 1), frame time
# left, scatter count, comoving p
SP_P0, SP_P1, SP_P2, SP_P3 = 0, 1, 2, 3
SP_X, SP_Y, SP_Z = 4, 5, 6
SP_Q, SP_U, SP_V = 7, 8, 9
SP_TREM = 10
SP_NS = 11
SP_C0, SP_C1, SP_C2, SP_C3 = 12, 13, 14, 15
N_STATE = 16

FLAG_ALIVE = 1
FLAG_POOL = 2
FLAG_INGRID = 4
DEFAULT_MFP = 1e12
TINY = rng.TINY
# theta = kT/(m_e c^2) at the 1e7 K switch between the thermal samplers
THETA_MB_SWITCH = 1.6863699656e-3
TWO_PI = 2.0 * math.pi
_INV_C = 1.0 / C_LIGHT
_INV_MP = 1.0 / M_P
EL_ITERS = 12
KN_ITERS = 12

# the ultra table's rows [v0, v1, ne_lab, temp]; the packed table's rows
PHYS = dict(v0=0, v1=1, ne_lab=2, temp=3)
PCOL = dict(r0=0, r1=1, r2=2, dr0=3, dr1=4, dr2=5, v0=6, v1=7, v2=8, gamma=9, dens_lab=10,
            temp=11, nonthermal_dens=12, sin1=13, cos1=14)


class Grid(NamedTuple):
    """Grid scalars, each exactly a float32 value: the strict domain
    (r0 in (dom0, dom1), r1 in (dom2, dom3)) and, on uniform grids, cell
    (i, j) = divmod(cell, n1) with centre (lo0 + (i + 0.5) d0, lo1 + (j +
    0.5) d1) and size (d0, d1)."""

    dom0: float
    dom1: float
    dom2: float
    dom3: float
    lo0: float = 0.0
    d0: float = 1.0
    lo1: float = 0.0
    d1: float = 1.0
    n1: int = 1


class Offsets(NamedTuple):
    free: int
    mb: int
    mj: int
    el: int
    acc: int
    theta: int
    phi: int
    per_round: int


def _offsets(el_iters: int, kn_iters: int) -> Offsets:
    """Static draw numbers within one round, in program order: free path,
    Maxwell-Boltzmann, the Maxwell-Juttner trials, the electron angles, the
    KN acceptance, the theta trials, the phi trials."""
    mj = 5
    el = mj + 5 * el_iters
    theta = el + 3
    phi = theta + 2 * kn_iters
    return Offsets(free=1, mb=2, mj=mj, el=el, acc=el + 2, theta=theta, phi=phi,
                   per_round=phi + 2 * kn_iters - 1)


OFFSETS = _offsets(EL_ITERS, KN_ITERS)


def _boost(bx, by, bz, p0, p1, p2, p3):
    """Photon Lorentz boost, then the null norm restored."""
    b2 = bx * bx + by * by + bz * bz
    pos = b2 > 0
    safe_b2 = torch.where(pos, b2, 1.0)
    gam = torch.rsqrt(torch.clamp(1.0 - b2, min=1e-30))
    bdotp = bx * p1 + by * p2 + bz * p3
    p0n = gam * (p0 - bdotp)
    coef = (gam - 1.0) * bdotp / safe_b2 - gam * p0
    q1 = torch.where(pos, p1 + coef * bx, p1)
    q2 = torch.where(pos, p2 + coef * by, p2)
    q3 = torch.where(pos, p3 + coef * bz, p3)
    p0n = torch.where(pos, p0n, p0)
    n = torch.sqrt(q1 * q1 + q2 * q2 + q3 * q3)
    scale = torch.where(n > 0, p0n / torch.clamp(n, min=TINY), 1.0)
    return p0n, q1 * scale, q2 * scale, q3 * scale


def _rotate_basis(vo, ro, vn, rn, q, u):
    """Stokes (q, u) rotation between the (v_old, ref_old) and (v_new,
    ref_new) bases.  Vectors are 3-tuples of tensors or floats."""
    vox, voy, voz = vo
    rox, roy, roz = ro
    vnx, vny, vnz = vn
    rnx, rny, rnz = rn
    ax = roy * voz - roz * voy
    ay = roz * vox - rox * voz
    az = rox * voy - roy * vox
    bx = rny * vnz - rnz * vny
    by = rnz * vnx - rnx * vnz
    bz = rnx * vny - rny * vnx
    dot_ab = ax * bx + ay * by + az * bz
    n2 = (ax * ax + ay * ay + az * az) * (bx * bx + by * by + bz * bz)
    d = torch.clamp(dot_ab * torch.rsqrt(torch.clamp(n2, min=TINY)), -1.0, 1.0)
    d = torch.where(n2 > 0, d, 0.0)
    cx = ay * voz - az * voy
    cy = az * vox - ax * voz
    cz = ax * voy - ay * vox
    f = torch.sign(cx * bx + cy * by + cz * bz)
    c2 = torch.where(f == 0, 1.0, 2.0 * d * d - 1.0)
    s2 = -f * 2.0 * d * torch.sqrt(torch.clamp(1.0 - d * d, min=0.0))
    return c2 * q - s2 * u, s2 * q + c2 * u


def _thermal_gamma_beta(base, k0, temp, dtype):
    """Thermal (gamma, gamma beta) per lane: the Maxwell-Boltzmann chi2_3
    speed below the 1e7 K switch, Maxwell-Juttner rejection above it."""
    off = OFFSETS
    theta = torch.clamp(temp * KB_OVER_MEC2, min=TINY)
    u1 = rng.uniform_pos(base, k0 + off.mb, dtype)
    u2 = rng.uniform_pos(base, k0 + off.mb + 1, dtype)
    u3 = rng.uniform(base, k0 + off.mb + 2, dtype)
    cosb = torch.cos(TWO_PI * u3)
    chi2_3 = -2.0 * torch.log(u1) - 2.0 * torch.log(u2) * (cosb * cosb)
    b2 = torch.clamp(theta * chi2_3, max=0.999999)
    g_mb = torch.rsqrt(1.0 - b2)
    gb_mb = g_mb * torch.sqrt(b2)
    sqrt_theta = torch.sqrt(theta)
    m3 = 2.0 * theta * sqrt_theta
    inv_mass = 1.0 / (1.0 + m3)
    cum1 = 0.5 * inv_mass
    cum2 = inv_mass
    xi = torch.full_like(theta, 1.5)
    done = torch.zeros_like(theta, dtype=torch.bool)
    for t in range(EL_ITERS):
        k = k0 + off.mj + 5 * t
        v0 = rng.uniform_pos(base, k, dtype)
        v1 = rng.uniform_pos(base, k + 1, dtype)
        v2 = rng.uniform_pos(base, k + 2, dtype)
        um = rng.uniform(base, k + 3, dtype)
        ua = rng.uniform(base, k + 4, dtype)
        p2 = v0 * v1
        prod = torch.where(um < cum1, v0, torch.where(um < cum2, p2, p2 * v2))
        cand = -torch.log(prod)
        a = theta * cand
        target = (1.0 + a) * torch.sqrt(torch.clamp(a * (2.0 + a), min=0.0))
        envelope = sqrt_theta * (1.0 + cand) + 2.0 * (theta * theta) * (cand * cand)
        ok = ua * envelope <= target
        xi = torch.where(ok & ~done, cand, xi)
        done = done | ok
    a = theta * xi
    g_mj = 1.0 + a
    gb_mj = torch.sqrt(torch.clamp(a * (2.0 + a), min=0.0))
    cold = theta < THETA_MB_SWITCH
    return torch.where(cold, g_mb, g_mj), torch.where(cold, gb_mb, gb_mj)


def _electron_from_gamma(base, k0, gamma, gb, c1, c2, c3, dtype):
    """Relative-angle draw and rotation into the photon's axes."""
    off = OFFSETS
    beta = gb / gamma
    uu = rng.uniform(base, k0 + off.el, dtype)
    safe_beta = torch.clamp(beta, min=1e-8)
    arg = 1.0 + safe_beta * safe_beta + 2.0 * safe_beta - 4.0 * safe_beta * uu
    cos_t = (1.0 - torch.sqrt(torch.clamp(arg, min=0.0))) / safe_beta
    cos_t = torch.where(beta < 1e-6, 2.0 * uu - 1.0, cos_t)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = rng.uniform(base, k0 + off.el + 1, dtype) * TWO_PI
    sp, cp = torch.sin(phi), torch.cos(phi)
    e1 = gb * cos_t
    e2 = gb * sin_t * sp
    e3 = gb * sin_t * cp
    rho2 = c2 * c2 + c3 * c3
    rho = torch.sqrt(rho2)
    norm = torch.sqrt(rho2 + c1 * c1)
    inv_norm = 1.0 / torch.clamp(norm, min=TINY)
    c_th = c1 * inv_norm
    s_th = rho * inv_norm
    safe_rho = torch.clamp(rho, min=TINY)
    has = rho > 0
    c_ph = torch.where(has, c3 / safe_rho, 1.0)
    s_ph = torch.where(has, c2 / safe_rho, 0.0)
    vx = c_th * e1 - s_th * e3
    vy = e2
    vz = s_th * e1 + c_th * e3
    wy = c_ph * vy + s_ph * vz
    wz = -s_ph * vy + c_ph * vz
    return gamma, vx, wy, wz


def _kn_cross_section(e):
    """sigma_KN / sigma_T: the closed form in float64, rounded once to the
    working precision; below e = 1e-3 the series 1 - 2 e."""
    se = torch.clamp(e.to(torch.float64), min=1e-10)
    full = 0.75 * (
        2.0 / (se * se)
        + (1.0 / (2.0 * se) - (1.0 + se) / (se * (se * se))) * torch.log1p(2.0 * se)
        + (1.0 + se) / ((1.0 + 2.0 * se) * (1.0 + 2.0 * se))
    )
    return torch.where(e >= 1e-3, full.to(e.dtype), 1.0 - 2.0 * e)


def _sample_kn_angles(base, k0, e0, q, u, stokes_on, dtype):
    """KN theta rejection, then the (polarized) phi disk-point rejection."""
    off = OFFSETS
    cos_theta = torch.zeros_like(e0)
    done = torch.zeros_like(e0, dtype=torch.bool)
    for t in range(KN_ITERS):
        k = k0 + off.theta + 2 * t
        c = 2.0 * rng.uniform(base, k, dtype) - 1.0
        y = 2.0 * rng.uniform(base, k + 1, dtype)
        m = 1.0 + e0 * (1.0 - c)
        f = (e0 * (1.0 - c) + 1.0 / m + c * c) / (m * m)
        ok = y < f
        cos_theta = torch.where(ok & ~done, c, cos_theta)
        done = done | ok
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    if stokes_on:
        mu = 1.0 + e0 * (1.0 - cos_theta)
        inv_mu = 1.0 / mu
        inv_mu3 = inv_mu * (inv_mu * inv_mu)
        f_theta = (inv_mu + inv_mu3 - (sin_theta * sin_theta) * inv_mu * inv_mu) * sin_theta
        pol_amp = sin_theta * (sin_theta * sin_theta) * inv_mu * inv_mu
        safe_qu = torch.clamp(torch.sqrt(q * q + u * u), min=TINY)
        cos2pm = q / safe_qu
        sin2pm = torch.abs(u) / safe_qu
        norm = f_theta + pol_amp * (q * cos2pm - u * sin2pm)
        unpolarized = (q == 0.0) & (u == 0.0)
        safe_norm = torch.where(norm != 0, norm, 1.0)
    x_acc = torch.ones_like(e0)
    y_acc = torch.zeros_like(e0)
    done = torch.zeros_like(e0, dtype=torch.bool)
    for t in range(KN_ITERS):
        k = k0 + off.phi + 2 * t
        x = 2.0 * rng.uniform(base, k, dtype) - 1.0
        y = 2.0 * rng.uniform(base, k + 1, dtype) - 1.0
        r2 = x * x + y * y
        ok = (r2 <= 1.0) & (r2 > TINY)
        if stokes_on:
            safe_r2 = torch.clamp(r2, min=TINY)
            c2 = (x * x - y * y) / safe_r2
            s2 = (2.0 * x * y) / safe_r2
            f = (f_theta + pol_amp * (q * c2 - u * s2)) / safe_norm
            ok = ok & (unpolarized | (r2 < f))
        take = ok & ~done
        x_acc = torch.where(take, x, x_acc)
        y_acc = torch.where(take, y, y_acc)
        done = done | ok
    inv_r = torch.rsqrt(torch.clamp(x_acc * x_acc + y_acc * y_acc, min=TINY))
    return cos_theta, sin_theta, x_acc * inv_r, y_acc * inv_r


def _fano_normalized(fi, fq, fu, fv):
    """(q, u, v) = (fq, fu, fv) / fi in float64, the degree of polarization
    held to 1, rounded once to the working precision.  The program divides
    in its working precision, where fi (the scattered intensity, > 0 in
    exact arithmetic) rounds to 0 for a fully polarized photon scattered
    near 90 degrees in the polarization plane, and its Stokes vector comes
    out NaN."""
    dtype = fi.dtype
    i = torch.clamp(fi.to(torch.float64), min=1e-300)
    q, u, v = (x.to(torch.float64) / i for x in (fq, fu, fv))
    deg = torch.sqrt(q * q + u * u + v * v)
    scale = torch.where(deg > 1.0, 1.0 / deg, 1.0)
    return (q * scale).to(dtype), (u * scale).to(dtype), (v * scale).to(dtype)


def _single_scatter(base, k0, g0, e1x, e1y, e1z, c0, c1, c2, c3, q, u, v, f_ref, stokes_on,
                    dtype):
    """One polarized KN scatter attempt in the electron rest frame.
    ``f_ref`` is the fluid-boost reference vector (beta_f, or z-hat where
    beta_f == 0)."""
    inv_g = 1.0 / g0
    bx, by, bz = e1x * inv_g, e1y * inv_g, e1z * inv_g
    r0, r1, r2, r3 = _boost(bx, by, bz, c0, c1, c2, c3)
    z_hat = (0.0, 0.0, 1.0)
    if stokes_on:
        q, u = _rotate_basis((c1, c2, c3), f_ref, (c1, c2, c3), (bx, by, bz), q, u)
        q, u = _rotate_basis((r1, r2, r3), (bx, by, bz), (r1, r2, r3), z_hat, q, u)
    e0 = r0
    rho0 = torch.sqrt(r1 * r1 + r2 * r2)
    has_xy = rho0 > 0
    safe_rho0 = torch.clamp(rho0, min=TINY)
    a_c0 = torch.where(has_xy, r1 / safe_rho0, 1.0)
    a_s0 = torch.where(has_xy, r2 / safe_rho0, 0.0)
    e_pos = e0 > 0
    inv_e0 = torch.where(e_pos, 1.0 / torch.clamp(e0, min=TINY), 0.0)
    a_c1 = torch.where(e_pos, rho0 * inv_e0, 1.0)
    a_s1 = r3 * inv_e0
    scattered = rng.uniform(base, k0 + OFFSETS.acc, dtype) <= _kn_cross_section(e0)
    ct, st, c_phi, s_phi = _sample_kn_angles(base, k0, e0, q, u, stokes_on, dtype)
    e1 = e0 / (1.0 + e0 * (1.0 - ct))
    sx = e1 * ct
    sy = e1 * st * s_phi
    sz = e1 * st * c_phi
    tx = a_c1 * sx - a_s1 * sz
    tz = a_s1 * sx + a_c1 * sz
    nx = a_c0 * tx - a_s0 * sy
    ny = a_s0 * tx + a_c0 * sy
    nz = tz
    if stokes_on:
        rv, nv = (r1, r2, r3), (nx, ny, nz)
        q2, u2 = _rotate_basis(rv, z_hat, nv, rv, q, u)
        cos_sc = (r1 * nx + r2 * ny + r3 * nz) / torch.clamp(e0 * e1, min=TINY)
        cos_sc = torch.clamp(cos_sc, -1.0, 1.0)
        # Fano matrix
        st2 = torch.clamp(1.0 - cos_sc * cos_sc, min=0.0)
        de = e0 - e1
        m00 = 1.0 + cos_sc * cos_sc + (1.0 - cos_sc) * de
        m11 = 1.0 + cos_sc * cos_sc
        m22 = 2.0 * cos_sc
        m33 = 2.0 * cos_sc + cos_sc * (1.0 - cos_sc) * de
        fi = m00 + st2 * q2
        fq = st2 + m11 * q2
        fu = m22 * u2
        fv = m33 * v
        q2, u2, v2 = _fano_normalized(fi, fq, fu, fv)
        q2, u2 = _rotate_basis(nv, rv, nv, (-bx, -by, -bz), q2, u2)
    else:
        q2, u2, v2 = q, u, v
    o0, o1, o2, o3 = _boost(-bx, -by, -bz, e1, nx, ny, nz)
    return scattered, o0, o1, o2, o3, q2, u2, v2


def _phi_components(px, py):
    """(cos, sin) of the photon azimuth from its components."""
    rho = torch.sqrt(px * px + py * py)
    has = rho > 0
    safe = torch.where(has, rho, 1.0)
    return torch.where(has, px / safe, 1.0), torch.where(has, py / safe, 0.0)


class _Cell:
    """A lane's cell quantities, fixed for the call: the fluid, the
    electron density and temperature, and the cell's centre and size, from
    the ultra table (uniform grids: physics rows, geometry from the index)
    or the packed table (every row)."""

    def __init__(self, source: str, table, cl, grid: Grid):
        self.grid = grid
        row = table[:, cl]
        if source == "packed":
            gam = row[PCOL["gamma"]]
            self.beta_mag = torch.sqrt(torch.clamp(1.0 - 1.0 / (gam * gam), min=0.0))
            self.n_e = row[PCOL["dens_lab"]] * _INV_MP
            self.temp = row[PCOL["temp"]]
            self.v = (row[PCOL["v0"]], row[PCOL["v1"]])
            self.centre = [row[PCOL["r0"]], row[PCOL["r1"]]]
            self.size = [row[PCOL["dr0"]], row[PCOL["dr1"]]]
        else:
            v0, v1 = row[PHYS["v0"]], row[PHYS["v1"]]
            self.beta_mag = torch.sqrt(v0 * v0 + v1 * v1)
            self.n_e = row[PHYS["ne_lab"]]
            self.temp = row[PHYS["temp"]]
            self.v = (v0, v1)
            i = torch.div(cl, grid.n1, rounding_mode="floor")
            idx = (i, cl - i * grid.n1)
            lo, d = (grid.lo0, grid.lo1), (grid.d0, grid.d1)
            self.centre = [lo[a] + (x.to(table.dtype) + 0.5) * d[a] for a, x in enumerate(idx)]
            self.size = [d[0], d[1]]

    def fluid_beta(self, px, py):
        """Fluid 3-velocity in MCRaT Cartesian at the photon position."""
        vr, bz = self.v
        c2, s2 = _phi_components(px, py)
        return vr * c2, vr * s2, bz

    def contains(self, px, py, pz):
        """Post-move membership: the lane's cell and the strict domain."""
        g = self.grid
        ctr, size = self.centre, self.size

        def in_axis(h, a):
            return 2.0 * torch.abs(h - ctr[a]) - size[a] <= 0

        h0 = torch.sqrt(px * px + py * py)
        return (in_axis(h0, 0) & in_axis(pz, 1)
                & (h0 > g.dom0) & (h0 < g.dom1) & (pz > g.dom2) & (pz < g.dom3))


def _rounds(st, alive, is_pool, in_grid, cell: _Cell, base, stokes_on, inner_rounds, dtype):
    """``inner_rounds`` rounds over a flat set of lanes.  Returns the new 16
    planes and the (stalled, promoted) masks."""
    (p0, p1, p2, p3, px, py, pz, q, u, v, t_rem, ns, c0, c1, c2, c3) = st
    beta_mag = cell.beta_mag
    n_sigma = cell.n_e * THOM_X_SECT
    off = OFFSETS
    z_hat = (0.0, 0.0, 1.0)
    stalled = torch.zeros_like(alive)
    promoted = torch.zeros_like(alive)
    for r in range(inner_rounds):
        k0 = r * off.per_round
        act = alive & (t_rem > 0) & ~stalled

        # 1. fluid beta at the photon position
        bx, by, bz = cell.fluid_beta(px, py)
        fl_norm = torch.sqrt(bx * bx + by * by + bz * bz)
        ph_norm = torch.sqrt(p1 * p1 + p2 * p2 + p3 * p3)
        denom = torch.clamp(fl_norm * ph_norm, min=TINY)
        cos_ang = (bx * p1 + by * p2 + bz * p3) / denom

        # 2. comoving four-momentum
        b0, b1, b2, b3 = _boost(bx, by, bz, p0, p1, p2, p3)
        upd = act & in_grid
        c0 = torch.where(upd, b0, c0)
        c1 = torch.where(upd, b1, c1)
        c2 = torch.where(upd, b2, c2)
        c3 = torch.where(upd, b3, c3)

        # Thomson rate in the lab frame
        rate = n_sigma * (1.0 - beta_mag * cos_ang)

        # 3. free path -> candidate step
        u1 = rng.uniform_pos(base, k0 + off.free, dtype)
        mfp = torch.where(
            in_grid & (rate > 0),
            -torch.log(u1) / torch.clamp(rate, min=TINY),
            DEFAULT_MFP,
        )
        dt_scatt = mfp * _INV_C
        will = act & in_grid & (dt_scatt < t_rem)
        dt = torch.where(will, dt_scatt, t_rem)
        dt = torch.where(act, dt, 0.0)

        # 4. advance along the lab direction at c (pool photons stay)
        inv_p0 = 1.0 / torch.clamp(p0, min=TINY)
        step = torch.where(act & ~is_pool, C_LIGHT * dt * inv_p0, 0.0)
        px = px + step * p1
        py = py + step * p2
        pz = pz + step * p3
        t_rem = t_rem - dt

        # 5. scatter attempt (null collision on KN reject); the chain's
        # fluid reference vector is z-hat where beta_f == 0
        if stokes_on:
            flow = fl_norm > 0
            f_ref = (torch.where(flow, bx, 0.0), torch.where(flow, by, 0.0),
                     torch.where(flow, bz, 1.0))
            mf_ref = (torch.where(flow, -bx, 0.0), torch.where(flow, -by, 0.0),
                      torch.where(flow, -bz, 1.0))
            pv = (p1, p2, p3)
            qc, uc = _rotate_basis(pv, z_hat, pv, f_ref, q, u)
        else:
            f_ref = None
            qc, uc = q, u
        g_e, gb_e = _thermal_gamma_beta(base, k0, cell.temp, dtype)
        g0, ex, ey, ez = _electron_from_gamma(base, k0, g_e, gb_e, c1, c2, c3, dtype)
        sc, o0, o1, o2, o3, q2, u2, v2 = _single_scatter(
            base, k0, g0, ex, ey, ez, c0, c1, c2, c3, qc, uc, v, f_ref, stokes_on, dtype)
        scattered = will & sc
        l0, l1, l2, l3 = _boost(-bx, -by, -bz, o0, o1, o2, o3)
        if stokes_on:
            inv_ge = 1.0 / g0
            ov, lv = (o1, o2, o3), (l1, l2, l3)
            ql, ul = _rotate_basis(
                ov, (-ex * inv_ge, -ey * inv_ge, -ez * inv_ge), ov, mf_ref, q2, u2)
            ql, ul = _rotate_basis(lv, mf_ref, lv, z_hat, ql, ul)
            q = torch.where(scattered, ql, q)
            u = torch.where(scattered, ul, u)
            v = torch.where(scattered, v2, v)
        p0 = torch.where(scattered, l0, p0)
        p1 = torch.where(scattered, l1, p1)
        p2 = torch.where(scattered, l2, p2)
        p3 = torch.where(scattered, l3, p3)
        c0 = torch.where(scattered, o0, c0)
        c1 = torch.where(scattered, o1, c1)
        c2 = torch.where(scattered, o2, c2)
        c3 = torch.where(scattered, o3, c3)
        ns = ns + scattered.to(ns.dtype)
        promoted = promoted | (scattered & is_pool)

        # 6. post-move cell and domain membership: stall lanes that left
        in_cell = cell.contains(px, py, pz)
        stalled = stalled | (act & in_grid & ~in_cell & (t_rem > 0))
    planes = (p0, p1, p2, p3, px, py, pz, q, u, v, t_rem, ns, c0, c1, c2, c3)
    return planes, stalled, promoted


def rounds(state, lanes, cell, flags, table, seed: int, grid: Grid, source: str,
           stokes_on: bool = True, inner_rounds: int = 4, block_lanes: int = 16384):
    """``inner_rounds`` rounds on the lanes ``lanes`` (indices into the
    (16, N) ``state``, which is updated IN PLACE); ``cell`` and ``flags``
    hold those lanes' cells (clamped to a valid index) and FLAG_* bits,
    ``table`` is the (W, Ncell) cell table of ``source`` ("ultra" or
    "packed").  Each lane draws the counter stream of (seed, lane).
    Returns the lanes' (stalled, promoted) masks."""
    sub = state[:, lanes]
    cl = torch.clamp(cell.long(), 0, table.shape[1] - 1)
    base = rng.lane_base(seed, lanes, block_lanes)
    planes, stalled, promoted = _rounds(
        tuple(sub[i] for i in range(N_STATE)),
        (flags & FLAG_ALIVE) != 0, (flags & FLAG_POOL) != 0, (flags & FLAG_INGRID) != 0,
        _Cell(source, table, cl, grid), base, stokes_on, inner_rounds, state.dtype)
    state[:, lanes] = torch.stack(planes)
    return stalled, promoted
