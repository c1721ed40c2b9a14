"""The fused transport round: plain PyTorch twin and CUDA kernel wrapper.

Port of ``mcrat_tpu/ops/pallas_round.py::fused_rounds`` with DIRECT
(Thomson) or TABLE (hot cross-section) optical depth, thermal electrons and,
in TABLE mode, nonthermal (broken) power-law electrons, Stokes on or off,
for every (dims x geometry) frame on a rectilinear grid or an AMR cell
list.  One call runs
``inner_rounds`` complete transport rounds per photon lane:

    comoving boost -> tau-rate -> free path -> move -> electron draw
    -> polarized Klein-Nishina scatter attempt -> Stokes -> cell membership

A lane that leaves its cell stalls until the caller re-resolves its cell
(``transport.transport_rounds_fused``).  Both implementations take the lane's
containing cell and gather their own values from a (W, Ncell) cell table;
the :data:`VARIANTS` (``pallas_round._make_kernel``'s static flags) differ in
that table and in the geometry of the fluid velocity and the membership test:

* ``ultra_*``: uniform grids; the table holds physics only (4 rows
  ``[v0, v1, ne_lab, temp]``, 5 rows ``[v0, v1, v2, ne_lab, temp]`` in 3-D)
  and the cell centre is ``lo + (i + 0.5) d`` (2-D spherical also takes the
  sin/cos of its theta centre);
* ``slim_cyl2``: non-uniform 2-D cartesian/cylindrical grids, the 8-row
  ``grid.PCOL_SLIM`` table;
* ``packed_*``: every other rectilinear frame, and every nonthermal one, the
  16/24-row ``grid.PCOL`` table; gamma comes from its row and
  n_e = dens_lab / m_p in float32.

TABLE mode appends ``hot_xsec.CHEB_ROWS`` per-cell Chebyshev rows to the
table at row ``cheb_base`` (the variant's width): sigma_hat is evaluated
every round at the current comoving energy (:func:`_cheb_eval`).
Nonthermal electrons (``nt``, :class:`NtConstants`) add the biased
multi-population rate, the population draw and the subgroup inverse-CDF
gamma (:func:`_population_gamma`), and two draws per round.  The carried
AMR path reads TABLE mode from two per-lane aux planes instead (``aux``,
(2, Npad): the biased total tau coefficient and the thermal probability,
``transport.aux_planes``) on the packed variants, and a lane stalls after
it scatters too, since its planes are then stale (pallas_round.py:879-888,
1078-1079).

:func:`fused_rounds_reference` is the plain twin, vectorized over lanes.
:func:`fused_rounds` is the wrapper: on CPU tensors it runs the twin, on CUDA
tensors it launches ``csrc/fused_round.cu`` (or raises) -- there is no path
back to the twin on the card.  Both update ``state`` IN PLACE (an idle lane's
state stays bit-identical) and return the (Npad,) int32 out-flags.  Each
keeps its own launch count (``fused_rounds.launches``,
``fused_rounds_reference.launches``).

Random numbers come from ``ops.rng`` (the interpret-mode hash of the JAX
kernel) with static draw numbers (:func:`draw_offsets`), so the twin, the
kernel and the JAX kernel in interpret mode agree lane for lane.

Differences from the JAX kernel, all deliberate:

* the Maxwell-Boltzmann / Maxwell-Juttner switch is made per lane
  (``theta < THETA_MB_SWITCH``, as the reference does per electron,
  Src/electron.c:206) rather than per block; the two agree on any frame whose
  blocks each have one temperature;
* fault F1 is repaired: where the fluid velocity is zero the Stokes rotation
  chain uses z-hat in place of the (degenerate) +-beta_f reference vector, so
  the z -> beta_e rotations are kept (as ``ops.stokes`` / ``transport_rounds``
  do).  Lanes with beta_f != 0 are unchanged;
* fault F6 is repaired: the Klein-Nishina closed form is evaluated in
  float64 and rounded once (:func:`_kn_cross_section`);
* fault F13 is repaired: the Fano Stokes terms are normalized by the
  scattered intensity in float64, the degree of polarization held to 1
  (``ops.stokes.fano_normalized``), where a float32 division gives NaN.
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..constants import C_LIGHT, KB_OVER_MEC2, M_P, THOM_X_SECT

from ..grid import PCOL, PCOL_SLIM
from . import rng
from .hot_xsec import CHEB_DHI, CHEB_DLO, CHEB_ROWS, LOG_PH_E_MAX
from .stokes import fano_normalized as _fano_normalized

# state plane layout (f32), as pallas_round.SP_*: lab p, position, Stokes
# q/u/v (I == 1), frame time left, scatter count, comoving p
SP_P0, SP_P1, SP_P2, SP_P3 = 0, 1, 2, 3
SP_X, SP_Y, SP_Z = 4, 5, 6
SP_Q, SP_U, SP_V = 7, 8, 9
SP_TREM = 10
SP_NS = 11
SP_C0, SP_C1, SP_C2, SP_C3 = 12, 13, 14, 15
N_STATE = 16

# lane flag bits in, out-flag bits out (pallas_round.FLAG_* / OUT_*)
FLAG_ALIVE = 1
FLAG_POOL = 2
FLAG_INGRID = 4
OUT_STALLED = 1
OUT_PROMOTED = 2

# ultra physics table rows: 2-D (the slim rows 4:8 of grid.PCOL_SLIM) and
# 3-D cartesian (+ v2)
PHYS_V0, PHYS_V1, PHYS_NE, PHYS_TEMP = 0, 1, 2, 3
N_PHYS = 4
PHYS3 = dict(v0=0, v1=1, v2=2, ne_lab=3, temp=4)

LANES = 128
WARP = 32
DEFAULT_MFP = 1e12
TINY = rng.TINY
# theta = kT/(m_e c^2) at the reference's 1e7 K thermal-sampler switch
THETA_MB_SWITCH = 1.6863699656e-3
TWO_PI = 2.0 * math.pi
_INV_C = 1.0 / C_LIGHT
# rejection trials per draw, as pallas_round.fused_rounds's defaults: 12
# Maxwell-Juttner trials, and 12 KN trials each for theta and phi
EL_ITERS = 12
KN_ITERS = 12


_INV_MP = 1.0 / M_P


class GridScalars(NamedTuple):
    """Grid scalars of the kernel, each exactly a float32 value.

    ``dom*`` bound the strict domain test (hydro r0 in (dom0, dom1), r1 in
    (dom2, dom3), r2 in (dom4, dom5)).  On uniform grids (the ultra
    variants) 2-D cell (i, j) = divmod(cell, n1) has centre
    (lo0 + (i + 0.5) d0, lo1 + (j + 0.5) d1) and size (d0, d1); 3-D cell
    (i, j, k), cell = (i n1 + j) n2 + k, adds lo2, d2.
    """

    dom0: float
    dom1: float
    dom2: float
    dom3: float
    lo0: float
    d0: float
    lo1: float
    d1: float
    n1: int
    dom4: float = 0.0
    dom5: float = 0.0
    lo2: float = 0.0
    d2: float = 1.0
    n2: int = 1


class Variant(NamedTuple):
    """One instantiation of the kernel (``pallas_round._make_kernel``'s
    static flags): its dispatch code in ``csrc/fused_round.cu``, the cell
    table it reads (``source`` and ``width`` rows), the membership geometry
    (``geom``: cyl2, sph2, cart3, sph3, pol3) and whether the fluid velocity
    carries a phi-hat component (2.5-D)."""

    code: int
    source: str
    geom: str
    v2: bool
    width: int
    replaces: str  # the pallas_round.py lines it replaces


VARIANTS = {
    "ultra_cyl2": Variant(0, "ultra", "cyl2", False, 4, "pallas_round.py:606-617,846-850,744-757"),
    "ultra_sph2": Variant(1, "ultra", "sph2", False, 4, "pallas_round.py:606-617,836-844,758-779"),
    "ultra_cart3": Variant(2, "ultra", "cart3", False, 5, "pallas_round.py:618-620,851-861,682-697"),
    "slim_cyl2": Variant(3, "slim", "cyl2", False, 8, "pallas_round.py:621-627,744-757"),
    "packed_cyl2": Variant(4, "packed", "cyl2", False, 16, "pallas_round.py:629-647,744-757"),
    "packed_cyl25": Variant(5, "packed", "cyl2", True, 16, "pallas_round.py:636-647,744-757"),
    "packed_sph2": Variant(6, "packed", "sph2", False, 16, "pallas_round.py:648-655,758-779"),
    "packed_sph25": Variant(7, "packed", "sph2", True, 16, "pallas_round.py:636-655,758-779"),
    "packed_cart3": Variant(8, "packed", "cart3", False, 16, "pallas_round.py:634-635,682-697"),
    "packed_sph3": Variant(9, "packed", "sph3", False, 24, "pallas_round.py:634-635,698-723"),
    "packed_pol3": Variant(10, "packed", "pol3", False, 16, "pallas_round.py:634-635,724-742"),
}


class DrawOffsets(NamedTuple):
    """Static draw numbers within one round (``k = round * per_round +
    offset``), in the JAX kernel's program order: free path, the
    Maxwell-Boltzmann branch (traced first by ``lax.cond``), the
    Maxwell-Juttner trials, with nonthermal electrons the population draw
    and the sampler's uniform (``pop``, ``pop + 1``; -1 without), the
    electron angles, the KN acceptance, the theta trials and the phi
    trials."""

    free: int
    mb: int
    mj: int
    pop: int
    el: int
    acc: int
    theta: int
    phi: int
    per_round: int


def draw_offsets(el_iters: int, kn_iters: int, nonthermal: bool = False) -> DrawOffsets:
    mj = 5
    pop = mj + 5 * el_iters if nonthermal else -1
    el = mj + 5 * el_iters + (2 if nonthermal else 0)
    theta = el + 3
    phi = theta + 2 * kn_iters
    return DrawOffsets(free=1, mb=2, mj=mj, pop=pop, el=el, acc=el + 2, theta=theta,
                       phi=phi, per_round=phi + 2 * kn_iters - 1)


OFFSETS = draw_offsets(EL_ITERS, KN_ITERS)
OFFSETS_NT = draw_offsets(EL_ITERS, KN_ITERS, nonthermal=True)

_LN10 = 2.302585092994046
_INV_LN10 = 0.4342944819032518


def _f32(x) -> float:
    return float(np.float32(x))


class NtConstants(NamedTuple):
    """Constants of the in-kernel nonthermal path, each a float32 value as
    the JAX kernel forms it: where its expression meets a float32 array a
    Python float is rounded once; only products JAX folds in Python (such as
    ``THOM_X_SECT * f1``) are formed in float64 first
    (pallas_round._make_nonthermal_gamma, :933-944, :972-983, :1019-1035).
    The kernel takes them as one runtime struct (:meth:`as_floats`)."""

    broken: bool  # broken power law, else power law
    p_is_1: bool  # power law: p == 1; broken: p1 == 1
    p2_is_1: bool
    n_gamma: float
    inv_n_gamma: float
    n_gamma_m1: float
    thom_f1: float  # THOM_X_SECT * f1 (subgroup 1's fraction)
    invk1: float  # subgroup-1 Chebyshev fit: inverse knee, 1 / span
    span1: float
    c1_lo: tuple  # (CHEB_DLO + 1) low and (CHEB_DHI + 1) high coefficients
    c1_hi: tuple
    lg_min: float
    dg: float
    ln10: float
    ln10_dg: float
    q: float  # power law: 1 - p, 1 / (1 - p)
    inv_q: float
    gmin: float  # broken power law
    gbrk: float
    a_norm: float
    a_cont: float  # a_norm * gamma_break^(p2 - p1)
    f_break: float
    om_p1: float  # 1 - p1, 1 - p2, gamma_min^(1 - p1), gamma_break^(1 - p2)
    om_p2: float
    gmin_pow: float
    gbrk_pow: float

    def as_floats(self) -> list:
        """The kernel's ``NtConsts`` struct, field by field."""
        out = []
        for v in self:
            out.extend(v if isinstance(v, tuple) else [float(v)])
        return out


N_NT_CONSTS = 39


def nonthermal_constants(cfg, sub1: tuple = None) -> NtConstants:
    """The :class:`NtConstants` of a nonthermal config, ``sub1`` the global
    subgroup-1 fit (``ops.hot_xsec._sub1_cheb_static``), from float64 Python
    arithmetic as ``pallas_round._make_nonthermal_gamma`` forms it.  The aux
    planes carry the rate, so the aux-plane family takes no fit (``sub1``
    None: its fields are 0)."""
    from ..config import NonthermalDist

    from .electrons import broken_power_law_norm

    if sub1 is None:
        sub1 = (0.0,) * (5 + CHEB_DLO + CHEB_DHI)
    lg_min = math.log10(cfg.gamma_min)
    dg = (math.log10(cfg.gamma_max) - lg_min) / cfg.n_gamma
    ln10 = math.log(10.0)
    n_lo = CHEB_DLO + 1
    kw = dict(
        n_gamma=_f32(cfg.n_gamma), inv_n_gamma=_f32(1.0 / cfg.n_gamma),
        n_gamma_m1=_f32(cfg.n_gamma - 1.0), thom_f1=_f32(THOM_X_SECT * sub1[0]),
        invk1=_f32(sub1[1]), span1=_f32(sub1[2]),
        c1_lo=tuple(_f32(c) for c in sub1[3:3 + n_lo]),
        c1_hi=tuple(_f32(c) for c in sub1[3 + n_lo:]),
        lg_min=_f32(lg_min), dg=_f32(dg), ln10=_f32(ln10), ln10_dg=_f32(ln10 * dg),
        q=0.0, inv_q=0.0, gmin=0.0, gbrk=0.0, a_norm=0.0, a_cont=0.0, f_break=0.0,
        om_p1=0.0, om_p2=0.0, gmin_pow=0.0, gbrk_pow=0.0,
    )
    if cfg.nonthermal_e_dist is NonthermalDist.POWERLAW:
        p = cfg.powerlaw_index
        q = 1.0 - p
        p_is_1 = abs(p - 1.0) < 1e-6
        kw.update(q=_f32(q), inv_q=0.0 if p_is_1 else _f32(1.0 / q))
        return NtConstants(broken=False, p_is_1=p_is_1, p2_is_1=False, **kw)
    p1, p2 = cfg.powerlaw_index_1, cfg.powerlaw_index_2
    gmin, gmax, gbrk = cfg.gamma_min, cfg.gamma_max, cfg.gamma_break
    a_norm = broken_power_law_norm(p1, p2, gmin, gmax, gbrk)
    cont = gbrk ** (p2 - p1)
    p1_is_1 = abs(p1 - 1.0) < 1e-6
    p2_is_1 = abs(p2 - 1.0) < 1e-6
    f_break = a_norm * (math.log(gbrk / gmin) if p1_is_1
                        else (gbrk ** (1.0 - p1) - gmin ** (1.0 - p1)) / (1.0 - p1))
    kw.update(gmin=_f32(gmin), gbrk=_f32(gbrk), a_norm=_f32(a_norm),
              a_cont=_f32(a_norm * cont), f_break=_f32(f_break),
              om_p1=_f32(1.0 - p1), om_p2=_f32(1.0 - p2),
              gmin_pow=_f32(gmin ** (1.0 - p1)), gbrk_pow=_f32(gbrk ** (1.0 - p2)))
    return NtConstants(broken=True, p_is_1=p1_is_1, p2_is_1=p2_is_1, **kw)


# ---------------------------------------------------------------------------
# component-form device functions (pallas_round.py names, same op order)
# ---------------------------------------------------------------------------


def _boost(bx, by, bz, p0, p1, p2, p3):
    """Photon Lorentz boost + zero_norm (pallas_round._boost)."""
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
    """Stokes (q, u) rotation between the (v_old, ref_old) and
    (v_new, ref_new) bases (pallas_round._rotate_basis).  Vectors are
    3-tuples of tensors or floats."""
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


def _thermal_gamma_beta(base, k0, temp, off: DrawOffsets, tally=None):
    """Thermal (gamma, gamma beta), chosen per lane: Maxwell-Boltzmann chi2_3
    speed draw below the 1e7 K switch, Maxwell-Juttner Gamma-mixture
    rejection above it (pallas_round._thermal_gamma_beta).  ``tally`` (a
    dict) receives each lane's Maxwell-Juttner trials up to acceptance
    (``mj``) and its branch (``cold``)."""
    theta = torch.clamp(temp * KB_OVER_MEC2, min=TINY)
    # Maxwell-Boltzmann: beta^2 = theta * chi2_3 from three uniforms
    u1 = rng.uniform_pos(base, k0 + off.mb)
    u2 = rng.uniform_pos(base, k0 + off.mb + 1)
    u3 = rng.uniform(base, k0 + off.mb + 2)
    cosb = torch.cos(TWO_PI * u3)
    chi2_3 = -2.0 * torch.log(u1) - 2.0 * torch.log(u2) * (cosb * cosb)
    b2 = torch.clamp(theta * chi2_3, max=0.999999)
    g_mb = torch.rsqrt(1.0 - b2)
    gb_mb = g_mb * torch.sqrt(b2)
    # Maxwell-Juttner
    sqrt_theta = torch.sqrt(theta)
    m3 = 2.0 * theta * sqrt_theta
    inv_mass = 1.0 / (1.0 + m3)
    cum1 = 0.5 * inv_mass
    cum2 = inv_mass
    xi = torch.full_like(theta, 1.5)
    done = torch.zeros_like(theta, dtype=torch.bool)
    trials = torch.zeros_like(theta)
    for t in range(EL_ITERS):
        trials = trials + (~done).to(theta.dtype)
        k = k0 + off.mj + 5 * t
        v0 = rng.uniform_pos(base, k)
        v1 = rng.uniform_pos(base, k + 1)
        v2 = rng.uniform_pos(base, k + 2)
        um = rng.uniform(base, k + 3)
        ua = rng.uniform(base, k + 4)
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
    if tally is not None:
        tally.update(mj=trials, cold=cold)
    return torch.where(cold, g_mb, g_mj), torch.where(cold, gb_mb, gb_mj)


def _electron_from_gamma(base, k0, off: DrawOffsets, gamma, gb, c1, c2, c3):
    """Relative-angle draw + rotation into the photon's axes
    (pallas_round._electron_from_gamma)."""
    beta = gb / gamma
    uu = rng.uniform(base, k0 + off.el)
    safe_beta = torch.clamp(beta, min=1e-8)
    arg = 1.0 + safe_beta * safe_beta + 2.0 * safe_beta - 4.0 * safe_beta * uu
    cos_t = (1.0 - torch.sqrt(torch.clamp(arg, min=0.0))) / safe_beta
    cos_t = torch.where(beta < 1e-6, 2.0 * uu - 1.0, cos_t)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = rng.uniform(base, k0 + off.el + 1) * TWO_PI
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
    """sigma_KN / sigma_T of float32 ``e`` (pallas_round._kn_cross_section,
    with fault F6 repaired): the closed form is evaluated in float64 and
    rounded once to float32.  In float32 its ~2/e^2 terms cancel to ~1 and
    lose up to 0.25 just above the e = 1e-3 switch; in float64 ~1e-10.  Below
    the switch the reference's 1 - 2 e (Src/mcrat_scattering.c:597-623)."""
    se = torch.clamp(e.to(torch.float64), min=1e-10)
    full = 0.75 * (
        2.0 / (se * se)
        + (1.0 / (2.0 * se) - (1.0 + se) / (se * (se * se))) * torch.log1p(2.0 * se)
        + (1.0 + se) / ((1.0 + 2.0 * se) * (1.0 + 2.0 * se))
    )
    return torch.where(e >= 1e-3, full.to(torch.float32), 1.0 - 2.0 * e)


def kn_cross_section(e):
    """sigma_KN / sigma_T of a 1-D float32 tensor: :func:`_kn_cross_section`
    on CPU tensors; on CUDA tensors one launch of the kernel's own device
    function (``csrc/fused_round.cu``, ``kn_cross_section_kernel``), counted
    in ``kn_cross_section.launches``."""
    if e.dtype != torch.float32 or e.dim() != 1 or not e.is_contiguous():
        raise ValueError("kn_cross_section takes a contiguous 1-D float32 tensor")
    if e.device.type == "cpu":
        return _kn_cross_section(e)
    if e.device.type != "cuda":
        raise ValueError(f"kn_cross_section runs on cpu or cuda tensors, not {e.device}")
    from .._build import load_fused_round

    lib = load_fused_round()
    out = torch.empty_like(e)
    err = lib.mcrat_kn_cross_section(e.data_ptr(), out.data_ptr(), ctypes.c_int64(e.numel()),
                                     torch.cuda.current_stream(e.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kn_cross_section kernel launch failed: "
                           f"{lib.mcrat_error_string(err).decode()}")
    kn_cross_section.launches += 1
    return out


kn_cross_section.launches = 0


def _sample_kn_angles(base, k0, off: DrawOffsets, e0, q, u, stokes_on, tally=None):
    """KN theta rejection + (polarized) phi disk-point rejection
    (pallas_round._sample_kn_angles).  ``tally`` (a dict) receives each
    lane's theta and phi trials up to acceptance."""
    cos_theta = torch.zeros_like(e0)
    done = torch.zeros_like(e0, dtype=torch.bool)
    theta_trials = torch.zeros_like(e0)
    for t in range(KN_ITERS):
        theta_trials = theta_trials + (~done).to(e0.dtype)
        k = k0 + off.theta + 2 * t
        c = 2.0 * rng.uniform(base, k) - 1.0
        y = 2.0 * rng.uniform(base, k + 1)
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
    phi_trials = torch.zeros_like(e0)
    for t in range(KN_ITERS):
        phi_trials = phi_trials + (~done).to(e0.dtype)
        k = k0 + off.phi + 2 * t
        x = 2.0 * rng.uniform(base, k) - 1.0
        y = 2.0 * rng.uniform(base, k + 1) - 1.0
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
    if tally is not None:
        tally.update(theta=theta_trials, phi=phi_trials)
    return cos_theta, sin_theta, x_acc * inv_r, y_acc * inv_r


def _single_scatter(base, k0, off: DrawOffsets, g0, e1x, e1y, e1z, c0, c1, c2, c3,
                    q, u, v, f_ref, stokes_on, tally=None):
    """One polarized KN scatter attempt in the electron rest frame
    (pallas_round._single_scatter, collapsed Stokes chain).  ``f_ref`` is
    the fluid-boost reference vector of the chain (beta_f, or z-hat where
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
    scattered = rng.uniform(base, k0 + off.acc) <= _kn_cross_section(e0)
    if tally is not None:
        tally["kn_double"] = e0 >= 1e-3
    ct, st, c_phi, s_phi = _sample_kn_angles(base, k0, off, e0, q, u, stokes_on, tally)
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
        # Fano matrix (ops.stokes.fano_scatter_stokes)
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
    """A variant's per-lane cell quantities, fixed for the call
    (pallas_round._kernel_body before round_body), and its ``fluid_beta``
    and ``contains`` (pallas_round fluid_beta, in_cell_and_domain)."""

    def __init__(self, var: Variant, table, cl, grid: GridScalars, cheb_base: int = 0,
                 nonthermal: bool = False):
        self.var, self.grid = var, grid
        dev = table.device

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        row = table[:, cl]
        geom = var.geom
        if var.source == "packed":
            gam = row[PCOL["gamma"]]
            self.beta_mag = torch.sqrt(torch.clamp(1.0 - 1.0 / (gam * gam), min=0.0))
            self.n_e = row[PCOL["dens_lab"]] * _INV_MP
            self.temp = row[PCOL["temp"]]
            self.v = (row[PCOL["v0"]], row[PCOL["v1"]], row[PCOL["v2"]])
        else:
            col = (PHYS3 if geom == "cart3" else PCOL_SLIM if var.source == "slim"
                   else dict(v0=PHYS_V0, v1=PHYS_V1, ne_lab=PHYS_NE, temp=PHYS_TEMP))
            v0, v1 = row[col["v0"]], row[col["v1"]]
            beta2 = v0 * v0 + v1 * v1
            v2 = None
            if geom == "cart3":
                v2 = row[col["v2"]]
                beta2 = beta2 + v2 * v2
            self.beta_mag = torch.sqrt(beta2)
            self.n_e = row[col["ne_lab"]]
            self.temp = row[col["temp"]]
            self.v = (v0, v1, v2)

        # cell geometry: centres and sizes along the hydro axes
        if var.source == "ultra":
            n1, n2 = grid.n1, grid.n2
            if geom == "cart3":
                i = torch.div(cl, n1 * n2, rounding_mode="floor")
                rem = cl - i * (n1 * n2)
                j = torch.div(rem, n2, rounding_mode="floor")
                idx = (i, j, rem - j * n2)
            else:
                i = torch.div(cl, n1, rounding_mode="floor")
                idx = (i, cl - i * n1)
            lo = (grid.lo0, grid.lo1, grid.lo2)
            d = (grid.d0, grid.d1, grid.d2)
            self.centre = [lo[a] + (x.to(torch.float32) + 0.5) * d[a] for a, x in enumerate(idx)]
            self.size = list(d[:len(idx)])
        elif var.source == "slim":
            c = PCOL_SLIM
            self.centre = [row[c["r0"]], row[c["r1"]]]
            self.size = [row[c["dr0"]], row[c["dr1"]]]
        else:
            self.centre = [row[PCOL["r0"]], row[PCOL["r1"]], row[PCOL["r2"]]]
            self.size = [row[PCOL["dr0"]], row[PCOL["dr1"]], row[PCOL["dr2"]]]

        # angular caches (cosine-space membership, spherical fluid basis)
        if geom == "sph2" and var.source == "ultra":
            self.s1 = torch.sin(self.centre[1])
            self.c1 = torch.cos(self.centre[1])
            self.cos_half1 = torch.cos(f32(0.5 * grid.d1))
        elif geom in ("sph2", "sph3", "pol3"):
            self.s1, self.c1 = row[PCOL["sin1"]], row[PCOL["cos1"]]
            self.cos_half1 = torch.cos(0.5 * row[PCOL["dr1"]])
        if geom in ("sph2", "sph3"):
            self.cos_dom2, self.cos_dom3 = torch.cos(f32(grid.dom2)), torch.cos(f32(grid.dom3))
        if geom == "sph3":
            self.s2, self.c2 = row[PCOL["sin2"]], row[PCOL["cos2"]]
            self.cos_half2 = torch.cos(0.5 * row[PCOL["dr2"]])
        if geom in ("sph3", "pol3"):
            # the azimuth domain, tested around its midpoint
            lo, hi = (grid.dom4, grid.dom5) if geom == "sph3" else (grid.dom2, grid.dom3)
            mid = 0.5 * (f32(lo) + f32(hi))
            self.cos_mid, self.sin_mid = torch.cos(mid), torch.sin(mid)
            self.cos_half_dom = torch.cos(0.5 * (f32(hi) - f32(lo)))

        # TABLE mode: the cell's Chebyshev rows, and the round-invariant
        # 1 / (LOG_PH_E_MAX - s) with s = -log10(inv_knee)
        self.cheb = bool(cheb_base)
        if self.cheb:
            ch = [table[cheb_base + i, cl] for i in range(CHEB_ROWS)]
            self.inv_knee = ch[0]
            lg_invk = torch.log(torch.clamp(self.inv_knee, min=TINY)) * _INV_LN10
            self.span_inv = 1.0 / (LOG_PH_E_MAX + lg_invk)
            self.c_lo, self.c_hi = ch[1:2 + CHEB_DLO], ch[2 + CHEB_DLO:]
        if nonthermal:
            self.nt_dens = row[PCOL["nonthermal_dens"]]
            self.gam = row[PCOL["gamma"]]

    def fluid_beta(self, px, py):
        """Fluid 3-velocity in MCRaT Cartesian at the photon position."""
        v0, v1, v2 = self.v
        geom = self.var.geom
        if geom in ("cart3", "sph3", "pol3"):
            return v0, v1, v2  # Cartesian already (grid.HydroFrameHost.packed)
        c2, s2 = _phi_components(px, py)
        if geom == "sph2":
            vr = v0 * self.s1 + v1 * self.c1
            bz = v0 * self.c1 - v1 * self.s1
        else:
            vr, bz = v0, v1
        if self.var.v2:
            return vr * c2 - v2 * s2, vr * s2 + v2 * c2, bz
        return vr * c2, vr * s2, bz

    def contains(self, px, py, pz):
        """Post-move membership: the lane's cell and the strict domain,
        angular coordinates in cosine space."""
        g = self.grid
        geom = self.var.geom
        ctr, size = self.centre, self.size

        def in_axis(h, a):
            return 2.0 * torch.abs(h - ctr[a]) - size[a] <= 0

        if geom == "cyl2":
            h0 = torch.sqrt(px * px + py * py)
            return (in_axis(h0, 0) & in_axis(pz, 1)
                    & (h0 > g.dom0) & (h0 < g.dom1) & (pz > g.dom2) & (pz < g.dom3))
        if geom == "cart3":
            return (in_axis(px, 0) & in_axis(py, 1) & in_axis(pz, 2)
                    & (px > g.dom0) & (px < g.dom1) & (py > g.dom2) & (py < g.dom3)
                    & (pz > g.dom4) & (pz < g.dom5))
        if geom == "pol3":
            rho = torch.sqrt(px * px + py * py)
            cphi, sphi = _phi_components(px, py)
            in_phi = cphi * self.c1 + sphi * self.s1 >= self.cos_half1
            in_phi_dom = cphi * self.cos_mid + sphi * self.sin_mid >= self.cos_half_dom
            return (in_axis(rho, 0) & in_phi & in_phi_dom & in_axis(pz, 2)
                    & (rho > g.dom0) & (rho < g.dom1) & (pz > g.dom4) & (pz < g.dom5))
        # spherical: theta in cosine space around the cell centre
        rho = torch.sqrt(px * px + py * py)
        r = torch.sqrt(rho * rho + pz * pz)
        inv_r = 1.0 / torch.clamp(r, min=TINY)
        cos_th = torch.clamp(pz * inv_r, -1.0, 1.0)
        sin_th = rho * inv_r
        in_theta = cos_th * self.c1 + sin_th * self.s1 >= self.cos_half1
        in_theta_dom = (cos_th < self.cos_dom2) & (cos_th > self.cos_dom3)
        ok = in_axis(r, 0) & in_theta & in_theta_dom & (r > g.dom0) & (r < g.dom1)
        if geom == "sph3":
            cphi, sphi = _phi_components(px, py)
            in_phi = cphi * self.c2 + sphi * self.s2 >= self.cos_half2
            in_phi_dom = cphi * self.cos_mid + sphi * self.sin_mid >= self.cos_half_dom
            ok = ok & in_phi & in_phi_dom
        return ok


def _cheb_eval(x_lin, span_inv, c_lo, c_hi):
    """Branch-select Clenshaw recurrence of a two-interval Chebyshev fit of
    log10 sigma: linear x below the KN knee (x < 1), log space above it
    (pallas_round._cheb_eval).  Coefficients are per-lane tensors (the
    cell's rows) or float32 Python floats (the global subgroup-1 fit)."""
    lo = x_lin < 1.0
    lgx = torch.log(torch.clamp(x_lin, min=TINY)) * _INV_LN10
    t = torch.where(lo, 2.0 * x_lin - 1.0, torch.clamp(2.0 * lgx * span_inv - 1.0, -1.0, 1.0))
    zero = torch.zeros_like(t)

    def at(c):
        return c if torch.is_tensor(c) else torch.full_like(t, c)

    bk1, bk2 = zero, zero
    for k in range(CHEB_DHI, 0, -1):
        ck = torch.where(lo, at(c_lo[k]) if k <= CHEB_DLO else zero, at(c_hi[k]))
        bk0 = ck + 2.0 * t * bk1 - bk2
        bk2, bk1 = bk1, bk0
    f = torch.where(lo, at(c_lo[0]), at(c_hi[0])) + t * bk1 - bk2
    return torch.exp(f * _LN10)


def _cdiv(x, c: float):
    """``x / c`` as a true division on every device (CUDA PyTorch multiplies
    by the reciprocal of a Python-number divisor, which the kernel and the
    JAX kernel do not)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _nonthermal_gamma(u, sub_f, nt: NtConstants):
    """Inverse-CDF gamma of the (broken) power law restricted to the lane's
    subgroup ``sub_f`` (0-based, float) for the uniform ``u``
    (pallas_round._make_nonthermal_gamma)."""
    ln10 = nt.ln10
    if not nt.broken:
        ln_lo = ln10 * (nt.lg_min + sub_f * nt.dg)
        ln_hi = ln_lo + nt.ln10_dg
        if nt.p_is_1:
            return torch.exp(ln_lo + u * (ln_hi - ln_lo))
        a = torch.exp(nt.q * ln_lo)
        b = torch.exp(nt.q * ln_hi)
        return torch.exp(nt.inv_q * torch.log(torch.clamp(a + u * (b - a), min=TINY)))

    def seg1(hi):  # integral of g^-p1 from gamma_min to hi
        if nt.p_is_1:
            return torch.log(_cdiv(hi, nt.gmin))
        return _cdiv(torch.exp(nt.om_p1 * torch.log(hi)) - nt.gmin_pow, nt.om_p1)

    def seg2(hi):  # integral of g^-p2 from gamma_break to hi
        if nt.p2_is_1:
            return torch.log(_cdiv(hi, nt.gbrk))
        return _cdiv(torch.exp(nt.om_p2 * torch.log(hi)) - nt.gbrk_pow, nt.om_p2)

    def cdf(g):
        below = nt.a_norm * seg1(torch.clamp(g, max=nt.gbrk))
        above = nt.f_break + nt.a_cont * seg2(torch.clamp(g, min=nt.gbrk))
        return torch.where(g <= nt.gbrk, below, above)

    g_lo = torch.exp(ln10 * (nt.lg_min + sub_f * nt.dg))
    g_hi = torch.exp(ln10 * (nt.lg_min + (sub_f + 1.0) * nt.dg))
    f_lo, f_hi = cdf(g_lo), cdf(g_hi)
    x = f_lo + u * (f_hi - f_lo)
    if nt.p_is_1:
        lo = nt.gmin * torch.exp(_cdiv(x, nt.a_norm))
    else:
        arg = nt.gmin_pow + _cdiv(nt.om_p1 * x, nt.a_norm)
        lo = torch.exp(_cdiv(torch.log(torch.clamp(arg, min=TINY)), nt.om_p1))
    x2 = _cdiv(x - nt.f_break, nt.a_cont)
    if nt.p2_is_1:
        hi = nt.gbrk * torch.exp(x2)
    else:
        arg2 = nt.gbrk_pow + nt.om_p2 * x2
        hi = torch.exp(_cdiv(torch.log(torch.clamp(arg2, min=TINY)), nt.om_p2))
    return torch.where(x <= nt.f_break, lo, hi)


def _population_gamma(base, k0, off: DrawOffsets, nt: NtConstants, p_th, g_th, gb_th,
                      tally=None):
    """Scattering population from the biased optical depths (transport.
    _tau_rate, generateSingleElectron, Src/electron.c:7-68): thermal with
    probability ``p_th``, else the subgroups in equal slices of the rest;
    a nonthermal lane takes its subgroup's inverse-CDF gamma.  ``tally``
    receives the population (``thermal``)."""
    u_pop = rng.uniform(base, k0 + off.pop)
    is_th = u_pop <= p_th
    if tally is not None:
        tally["thermal"] = is_th
    slice_w = torch.clamp((1.0 - p_th) * nt.inv_n_gamma, min=TINY)
    sub_f = torch.clamp(torch.floor((u_pop - p_th) / slice_w), 0.0, nt.n_gamma_m1)
    g_nt = _nonthermal_gamma(rng.uniform(base, k0 + off.pop + 1), sub_f, nt)
    gb_nt = torch.sqrt(torch.clamp(g_nt * g_nt - 1.0, min=0.0))
    return torch.where(is_th, g_th, g_nt), torch.where(is_th, gb_th, gb_nt)


def warp_tally(mask, lanes, block: int):
    """(any-lane warps, dense warps) of a branch taken on ``mask`` of the
    lanes ``lanes`` (ascending kernel lane numbers): the 32-lane warps in
    which any lane takes it, and the warps it needs once each CUDA block of
    ``block`` threads (:func:`cuda_block`) packs its lanes that take it (the
    sum over blocks of ceil(count / 32)).  Two 0-d tensors; no host sync."""
    sel = lanes[mask]
    warp = torch.div(sel, WARP, rounding_mode="floor")
    blk = torch.div(sel, block, rounding_mode="floor")
    first = torch.ones_like(sel, dtype=torch.bool)
    first[1:] = warp[1:] != warp[:-1]
    starts = torch.ones_like(sel, dtype=torch.bool)
    starts[1:] = blk[1:] != blk[:-1]
    idx = torch.arange(sel.numel(), device=sel.device)
    rank = idx - torch.cummax(torch.where(starts, idx, 0), 0).values
    return first.sum(), (rank % WARP == 0).sum()


def _rounds(st, alive, is_pool, in_grid, cell: _Cell, base, stokes_on, inner_rounds,
            nt: NtConstants = None, aux=None, work=None, lanes=None, block=None):
    """``inner_rounds`` rounds over a flat set of lanes (pallas_round
    round_body).  ``aux`` is None or the lanes' (2, n) aux planes.  ``work``
    (a Counter) adds up the work the kernel does on these lanes, ``lanes``
    their kernel lane numbers, ``block`` the kernel's CUDA block: the
    :data:`WORK_KEYS`.  Returns the new 16 planes and the (stalled,
    promoted) masks."""
    (p0, p1, p2, p3, px, py, pz, q, u, v, t_rem, ns, c0, c1, c2, c3) = st
    beta_mag = cell.beta_mag
    if aux is None:
        n_sigma = cell.n_e * THOM_X_SECT
    else:
        # TABLE through the aux planes: the biased total tau coefficient
        # and the thermal probability, fixed for the call
        n_sigma, p_th = aux[0], aux[1]
    off = OFFSETS if nt is None else OFFSETS_NT
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

        # tau rate (transport._tau_rate).  DIRECT: Thomson.  TABLE: sigma_hat
        # at the CURRENT comoving energy, after the boost; nonthermal adds
        # the biased subgroup total tau0 + N_GAMMA tau_norm, tau_norm = tau0
        # in thermal cells, else subgroup 1's (Src/optical_depth.c:60-112)
        if cell.cheb:
            nsig_th = n_sigma * _cheb_eval(c0 * cell.inv_knee, cell.span_inv,
                                           cell.c_lo, cell.c_hi)
            if nt is not None:
                nsig_nt1 = (cell.nt_dens * cell.gam * nt.thom_f1) * _cheb_eval(
                    c0 * nt.invk1, nt.span1, nt.c1_lo, nt.c1_hi)
                taunorm = torch.where(cell.n_e > 0, nsig_th, nsig_nt1)
                total = nsig_th + nt.n_gamma * taunorm
                rate = total * (1.0 - beta_mag * cos_ang)
                p_th = nsig_th / torch.clamp(total, min=TINY)
            else:
                rate = nsig_th * (1.0 - beta_mag * cos_ang)
        else:
            rate = n_sigma * (1.0 - beta_mag * cos_ang)

        # 3. free path -> candidate step
        u1 = rng.uniform_pos(base, k0 + off.free)
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

        # 5. scatter attempt (null collision on KN reject).  F1 repair: the
        # chain's fluid reference vector is z-hat where beta_f == 0.
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
        tally = {} if work is not None else None
        g_e, gb_e = _thermal_gamma_beta(base, k0, cell.temp, off, tally)
        if nt is not None:
            g_e, gb_e = _population_gamma(base, k0, off, nt, p_th, g_e, gb_e, tally)
        g0, ex, ey, ez = _electron_from_gamma(base, k0, off, g_e, gb_e, c1, c2, c3)
        sc, o0, o1, o2, o3, q2, u2, v2 = _single_scatter(
            base, k0, off, g0, ex, ey, ez, c0, c1, c2, c3, qc, uc, v, f_ref, stokes_on, tally)
        scattered = will & sc
        if work is not None:
            th = will & tally.get("thermal", torch.ones_like(will))
            for key, n in (("lane_rounds", act), ("in_grid_rounds", act & in_grid),
                           ("attempts", will), ("mb", th & tally["cold"]),
                           ("mj_trials", torch.where(th & ~tally["cold"], tally["mj"], 0.0)),
                           ("nt_draws", will & ~th), ("scatters", scattered),
                           ("kn_double", will & tally["kn_double"]),
                           ("theta_trials", torch.where(scattered, tally["theta"], 0.0)),
                           ("phi_trials", torch.where(scattered, tally["phi"], 0.0))):
                work[key] = work[key] + n.sum()  # a tensor: no host sync
            mj = th & ~tally["cold"]
            branches = (("attempts", [will]), ("nt_draws", [will & ~th]), ("scatters", [scattered]),
                        ("mj_trials", [mj & (tally["mj"] > t) for t in range(EL_ITERS)]))
            for key, masks in branches:
                for m in masks:
                    n_any, n_dense = warp_tally(m, lanes, block)
                    work["warps_any_" + key] = work["warps_any_" + key] + n_any
                    work["warps_dense_" + key] = work["warps_dense_" + key] + n_dense
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

        # 6. post-move cell/domain membership: stall lanes that left; with
        # aux planes also lanes that scattered (their planes are stale)
        in_cell = cell.contains(px, py, pz)
        stalled = stalled | (act & in_grid & ~in_cell & (t_rem > 0))
        if aux is not None:
            stalled = stalled | (scattered & (t_rem > 0))
    planes = (p0, p1, p2, p3, px, py, pz, q, u, v, t_rem, ns, c0, c1, c2, c3)
    return planes, stalled, promoted


def _check_args(state, cell, flags, table, block_act, block_lanes, variant, cheb_base, nt,
                aux=None, row_map=None):
    if variant not in VARIANTS:
        raise ValueError(f"unknown kernel variant {variant!r}; one of {sorted(VARIANTS)}")
    var = VARIANTS[variant]
    if cheb_base not in (0, var.width):
        raise ValueError(f"cheb_base of {variant} is 0 (DIRECT) or {var.width} (TABLE), "
                         f"not {cheb_base}")
    if aux is not None and (cheb_base or var.source != "packed"):
        raise ValueError(f"aux planes run on a packed variant without Chebyshev rows, not "
                         f"{variant} with cheb_base={cheb_base}")
    if nt is not None and not ((cheb_base or aux is not None) and var.source == "packed"):
        raise ValueError(f"nonthermal electrons need TABLE rows or aux planes on a packed "
                         f"variant, not {variant} with cheb_base={cheb_base}")
    width = var.width + (CHEB_ROWS if cheb_base else 0)
    n = state.shape[1]
    if state.dim() != 2 or state.shape[0] != N_STATE or state.dtype != torch.float32:
        raise ValueError(f"state must be ({N_STATE}, Npad) float32, got "
                         f"{tuple(state.shape)} {state.dtype}")
    if not state.is_contiguous():
        raise ValueError("state must be contiguous")
    if block_lanes % LANES or n % block_lanes:
        raise ValueError(f"Npad={n} must be a multiple of block_lanes={block_lanes}, "
                         f"itself a multiple of {LANES}")
    for name, t, dt in (("cell", cell, torch.int32), ("flags", flags, torch.int32),
                        ("block_act", block_act, torch.int32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dt} tensor")
    if cell.shape[0] != n or flags.shape[0] != n:
        raise ValueError("cell and flags must have one entry per lane")
    if block_act.shape[0] != n // block_lanes:
        raise ValueError("block_act must have one entry per block")
    if aux is not None and (aux.dim() != 2 or tuple(aux.shape) != (2, n)
                            or aux.dtype != torch.float32 or not aux.is_contiguous()):
        raise ValueError(f"aux must be a contiguous (2, {n}) float32 tensor, got "
                         f"{tuple(aux.shape)} {aux.dtype}")
    if row_map is not None and (row_map.dim() != 1 or row_map.shape[0] != n // LANES
                                or row_map.dtype != torch.int32
                                or not row_map.is_contiguous()):
        raise ValueError(f"row_map must be a contiguous ({n // LANES},) int32 tensor, got "
                         f"{tuple(row_map.shape)} {row_map.dtype}")
    if (table.dim() != 2 or table.shape[0] != width or table.dtype != torch.float32
            or not table.is_contiguous() or table.shape[1] == 0):
        raise ValueError(f"the {variant} cell table (phys/packed) must be a contiguous "
                         f"({width}, Ncell) float32 tensor, got {tuple(table.shape)} "
                         f"{table.dtype}")
    devs = {t.device for t in (state, cell, flags, table, block_act, aux, row_map)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def fused_rounds_reference(state, cell, flags, table, block_act, seed: int,
                           grid: GridScalars, stokes_on: bool = True,
                           inner_rounds: int = 4, block_lanes: int = 16384,
                           variant: str = "ultra_cyl2", cheb_base: int = 0,
                           nt: NtConstants = None, aux=None, row_map=None):
    """Plain PyTorch twin of the fused-round kernel.

    ``state`` (16, Npad) f32 is updated IN PLACE on the lanes of active
    blocks; ``cell`` (Npad,) i32 is each lane's containing cell (clamped to
    a valid index), ``flags`` (Npad,) i32 its FLAG_* bits, ``table`` the
    variant's (W, Ncell) cell table (:data:`VARIANTS`), ``block_act``
    (Npad / block_lanes,) i32 marks blocks with at least one active lane.
    TABLE mode (``cheb_base`` = the variant's width) reads the CHEB_ROWS
    Chebyshev rows appended to the table; ``aux`` (2, Npad) float32 runs
    TABLE mode from per-lane aux planes instead (packed variants,
    ``cheb_base`` 0); ``nt`` adds nonthermal electrons (packed variants,
    TABLE mode only).  ``row_map`` (Npad / LANES,) int32, a permutation of
    the 128-lane rows (None: the identity), puts logical lane ``l`` at the
    physical lane ``row_map[l // LANES] * LANES + l % LANES``: a logical
    lane keeps its logical block's ``block_act`` and its counter stream,
    and reads and writes its state, ``cell``, ``flags``, ``aux`` and
    out-flag at its physical lane.  Returns the (Npad,) int32 out-flags
    (OUT_STALLED | OUT_PROMOTED; 0 on idle blocks).
    """
    _check_args(state, cell, flags, table, block_act, block_lanes, variant, cheb_base, nt, aux,
                row_map)
    fused_rounds_reference.launches += 1
    n = state.shape[1]
    out = torch.zeros(n, dtype=torch.int32, device=state.device)
    lane_on = torch.repeat_interleave(block_act != 0, block_lanes)
    lanes = torch.nonzero(lane_on).flatten()
    if lanes.numel() == 0:
        return out
    phys = lanes if row_map is None else row_map[lanes // LANES].long() * LANES + lanes % LANES
    sub = state[:, phys]
    fl = flags[phys]
    cl = torch.clamp(cell[phys].long(), 0, table.shape[1] - 1)
    base = rng.lane_base(seed, lanes, block_lanes)
    planes, stalled, promoted = _rounds(
        tuple(sub[i] for i in range(N_STATE)),
        (fl & FLAG_ALIVE) != 0, (fl & FLAG_POOL) != 0, (fl & FLAG_INGRID) != 0,
        _Cell(VARIANTS[variant], table, cl, grid, cheb_base, nt is not None), base,
        stokes_on, inner_rounds, nt, None if aux is None else aux[:, phys],
        fused_rounds_reference.work, lanes,
        cuda_block(variant, tau_family(cheb_base, nt, aux is not None), stokes_on),
    )
    state[:, phys] = torch.stack(planes)
    out[phys] = stalled.to(torch.int32) * OUT_STALLED + promoted.to(torch.int32) * OUT_PROMOTED
    return out


fused_rounds_reference.launches = 0
# the kernel's work on the twin's inputs (see _rounds): None, or a
# collections.Counter that the twin's calls add to, for a caller that counts
# a call's operations (its operation bound): lane rounds, attempts, draws,
# rejection trials, scatters, attempts that evaluate the double KN form
# (kn_double) and, for the branches attempts, mj_trials (each
# Maxwell-Juttner trial), nt_draws and scatters, the warps that run them
# (warp_tally): warps_any_* with one thread a lane, warps_dense_* once each
# CUDA block packs the branch's lanes
WARP_BRANCHES = ("attempts", "mj_trials", "nt_draws", "scatters")
WORK_KEYS = ("lane_rounds", "in_grid_rounds", "attempts", "mb", "mj_trials", "nt_draws",
             "scatters", "theta_trials", "phi_trials", "kn_double",
             *(f"warps_{k}_{b}" for b in WARP_BRANCHES for k in ("any", "dense")))
fused_rounds_reference.work = None

# the kernel's optical-depth families (csrc/fused_round.cu enum Tau)
TAU_DIRECT, TAU_CHEB, TAU_CHEB_NT, TAU_AUX, TAU_AUX_NT = 0, 1, 2, 3, 4
_TAU_SUFFIX = {TAU_DIRECT: "", TAU_CHEB: "+cheb", TAU_CHEB_NT: "+cheb+nt", TAU_AUX: "+aux",
               TAU_AUX_NT: "+aux+nt"}


def tau_family(cheb_base: int, nt, aux: bool = False) -> int:
    if aux:
        return TAU_AUX_NT if nt is not None else TAU_AUX
    return TAU_CHEB_NT if nt is not None else (TAU_CHEB if cheb_base else TAU_DIRECT)


def instantiation(variant: str, cheb_base: int = 0, nt=None, stokes_on: bool = True,
                  aux: bool = False) -> str:
    """The name of a kernel instantiation: the variant, ``+cheb`` in TABLE
    mode with Chebyshev rows, ``+aux`` in TABLE mode with aux planes,
    ``+nt`` with nonthermal electrons, ``/stokes_off`` without Stokes
    (``ultra_cyl2``, ``packed_sph2+cheb+nt/stokes_off``,
    ``packed_cyl2+aux``, ...)."""
    return (variant + _TAU_SUFFIX[tau_family(cheb_base, nt, aux)]
            + ("" if stokes_on else "/stokes_off"))


def instantiation_specs() -> list:
    """(name, variant, optical-depth family, stokes_on) of all 86 kernel
    instantiations: DIRECT and CHEB on the 11 variants, CHEB_NT, AUX and
    AUX_NT on the 7 packed ones, each with Stokes on and off."""
    return [(instantiation(v, var.width if tau in (TAU_CHEB, TAU_CHEB_NT) else 0,
                           True if tau in (TAU_CHEB_NT, TAU_AUX_NT) else None, s,
                           aux=tau in (TAU_AUX, TAU_AUX_NT)), v, tau, s)
            for tau in (TAU_DIRECT, TAU_CHEB, TAU_CHEB_NT, TAU_AUX, TAU_AUX_NT)
            for v, var in VARIANTS.items()
            if tau in (TAU_DIRECT, TAU_CHEB) or var.source == "packed" for s in (True, False)]


def instantiations() -> list:
    """The names of all 86 kernel instantiations (:func:`instantiation_specs`)."""
    return [spec[0] for spec in instantiation_specs()]


def layout_floats(variant: str, tau: int) -> int:
    """Floats a lane keeps in the kernel's shared memory (csrc/fused_round.cu
    Layout::COUNT): 16 state planes, 12 cell and exchange fields, the phi-hat
    or 3-D velocity, 3-D centre and size, the angular cells' sines and
    cosines, the nonthermal and aux fields, and in CHEB families the knee,
    the span and the Chebyshev coefficients."""
    var = VARIANTS[variant]
    d3 = var.geom in ("cart3", "sph3", "pol3")
    return (N_STATE + 12 + (var.v2 or d3) + 2 * d3
            + 3 * (var.geom in ("sph2", "sph3", "pol3")) + 3 * (var.geom == "sph3")
            + 2 * (tau == TAU_CHEB_NT) + (tau == TAU_AUX_NT)
            + (4 + CHEB_DLO + CHEB_DHI) * (tau in (TAU_CHEB, TAU_CHEB_NT)))


SM_SMEM = 228 * 1024  # shared memory of an H100 SM
BLOCK_SMEM_EXTRA = 4096  # a block's static arrays and the runtime's 1 KB, with room


def cuda_block(variant: str, tau: int, stokes_on: bool) -> int:
    """Threads of the kernel's CUDA block for an instantiation (the block
    that runs its rounds together and packs its accepted scatters;
    csrc/fused_round.cu block_threads): 512 with Stokes where two such
    blocks fit an SM's shared memory, else 256."""
    wide = 2 * (layout_floats(variant, tau) * 512 * 4 + BLOCK_SMEM_EXTRA) <= SM_SMEM
    return 512 if stokes_on and wide else 256


def kernel_attributes(lib, variant: str, tau: int, stokes_on: bool) -> dict:
    """An instantiation's launch shape and resources in a built library
    (``mcrat_fused_rounds_attrs``): ``threads`` a block, ``dyn_smem`` and
    ``static_smem`` bytes of shared memory a block, and as the CUDA runtime
    reports them for the loaded code, ``registers`` and ``local_bytes``
    (spills and stack) a thread.  Raises on an error."""
    fn = lib.mcrat_fused_rounds_attrs
    fn.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(VARIANTS[variant].code, tau, int(stokes_on), out)
    if err != 0:
        raise RuntimeError(f"mcrat_fused_rounds_attrs({variant}, {tau}) failed: "
                           f"{lib.mcrat_error_string(err).decode()}")
    return dict(zip(("threads", "dyn_smem", "registers", "local_bytes", "static_smem"), out))


def fused_rounds(state, cell, flags, table, block_act, seed: int,
                 grid: GridScalars, stokes_on: bool = True,
                 inner_rounds: int = 4, block_lanes: int = 16384,
                 variant: str = "ultra_cyl2", cheb_base: int = 0,
                 nt: NtConstants = None, aux=None, row_map=None):
    """Run ``inner_rounds`` fused transport rounds over the lane planes.

    Same contract as :func:`fused_rounds_reference` (``state`` updated in
    place, out-flags returned).  CPU tensors run the plain twin; CUDA tensors
    launch the hand-written kernel of ``csrc/fused_round.cu`` on the current
    stream, building it on first use, and raise if the build or the launch
    fails.  ``fused_rounds.launches`` counts kernel launches,
    ``fused_rounds.variant_launches`` the same per :func:`instantiation`
    (86 in all, :func:`instantiations`).
    """
    if state.device.type == "cpu":
        return fused_rounds_reference(
            state, cell, flags, table, block_act, seed, grid, stokes_on,
            inner_rounds, block_lanes, variant, cheb_base, nt, aux, row_map)
    if state.device.type != "cuda":
        raise ValueError(f"fused_rounds runs on cpu or cuda tensors, not {state.device}")
    _check_args(state, cell, flags, table, block_act, block_lanes, variant, cheb_base, nt, aux,
                row_map)
    from .._build import load_fused_round

    out = launch(load_fused_round(), torch.cuda.current_stream(state.device).cuda_stream,
                 state, cell, flags, table, block_act, seed, grid, stokes_on, inner_rounds,
                 block_lanes, variant, cheb_base, nt, aux, row_map)
    fused_rounds.launches += 1
    fused_rounds.variant_launches[instantiation(variant, cheb_base, nt, stokes_on,
                                                aux is not None)] += 1
    return out


def launch(lib, stream, state, cell, flags, table, block_act, seed: int, grid: GridScalars,
           stokes_on: bool, inner_rounds: int, block_lanes: int, variant: str,
           cheb_base: int, nt: NtConstants, aux, row_map=None):
    """One call of ``lib.mcrat_fused_rounds`` (a library bound by
    ``_build.bind_fused_round``; ``mcrat_fused_rounds_mapped`` with a
    ``row_map``) on ``stream``, on arguments that :func:`_check_args`
    accepts; raises if the call returns an error.
    Counts nothing: :func:`fused_rounds` is the port's entry point, and this
    is the call it makes, shared with tools that load another build of the
    same source (``tools/kernel_ab.py``)."""
    n = state.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=state.device)
    f = ctypes.c_float
    consts = (f * N_NT_CONSTS)(*(nt.as_floats() if nt is not None else [0.0] * N_NT_CONSTS))
    args = (
        ctypes.c_int32(VARIANTS[variant].code),
        ctypes.c_int32(tau_family(cheb_base, nt, aux is not None)),
        state.data_ptr(), ctypes.c_int64(n), cell.data_ptr(), flags.data_ptr(),
        table.data_ptr(), ctypes.c_int64(table.shape[1]), block_act.data_ptr(),
        out.data_ptr(), ctypes.c_int32(rng_seed_i32(seed)),
        *(f(x) for x in (grid.dom0, grid.dom1, grid.dom2, grid.dom3, grid.dom4, grid.dom5,
                         grid.lo0, grid.d0, grid.lo1, grid.d1, grid.lo2, grid.d2)),
        ctypes.c_int32(grid.n1), ctypes.c_int32(grid.n2), ctypes.c_int32(int(stokes_on)),
        ctypes.c_int32(inner_rounds), ctypes.c_int32(EL_ITERS),
        ctypes.c_int32(KN_ITERS), ctypes.c_int32(block_lanes),
        f(KB_OVER_MEC2), f(THOM_X_SECT), f(C_LIGHT), f(_INV_C), f(_INV_MP),
        ctypes.c_int32(cheb_base), consts, ctypes.c_int32(N_NT_CONSTS),
        None if aux is None else aux.data_ptr(),
    )
    if row_map is None:
        err = lib.mcrat_fused_rounds(*args, stream)
    else:
        err = lib.mcrat_fused_rounds_mapped(*args, row_map.data_ptr(), stream)
    if err != 0:
        name = instantiation(variant, cheb_base, nt, stokes_on, aux is not None)
        msg = lib.mcrat_error_string(err).decode()
        raise RuntimeError(f"fused_round kernel launch failed ({name}): {msg}")
    return out


fused_rounds.launches = 0
fused_rounds.variant_launches = collections.Counter()


def rng_seed_i32(seed: int) -> int:
    """Wrap a seed to int32, as the JAX glue's int32 arithmetic does."""
    s = int(seed) & rng.MASK32
    return s - (1 << 32) if s >= (1 << 31) else s
