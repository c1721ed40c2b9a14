"""Electron distributions and samplers (port of ``mcrat_tpu.ops.electrons``).

The host functions a nonthermal frame needs: the power-law and broken
power-law normalizations, pdfs, CDFs and mean energies (reference:
Src/electron.c:334-652).  Normalizations are Python floats; pdfs and CDFs
take numpy arrays or torch tensors.  Below them, the XLA engine's samplers
(thermal Maxwell-Juttner, nonthermal power laws, the relative polar angle
and the rotation into the photon's frame), drawing from threefry keys.  The
in-kernel samplers are in ``ops.fused_round``.
"""
from __future__ import annotations

import math

import torch

from ..config import NonthermalDist
from ..constants import KB_OVER_MEC2, ME_C2

from .._xp import xp_for
from .fourvec import rotate_about_x_cs, rotate_about_y_cs
from .prng import Key, batched_rejection, uniform_pos


def power_law_norm(p, gamma_min, gamma_max):
    """Normalization A of n(g) = A g^-p (reference: Src/electron.c:447-476)."""
    if abs(p - 1.0) < 1e-10:
        return 1.0 / math.log(gamma_max / gamma_min)
    return (1.0 - p) / (gamma_max ** (1.0 - p) - gamma_min ** (1.0 - p))


def broken_power_law_norm(p1, p2, gamma_min, gamma_max, gamma_break):
    """Normalization A of the broken power law (reference: Src/electron.c:334-371)."""
    p1_is_1 = abs(p1 - 1.0) < 1e-10
    p2_is_1 = abs(p2 - 1.0) < 1e-10
    if not p1_is_1 and not p2_is_1:
        t1 = (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
        t2 = gamma_break ** (p2 - p1) * (
            gamma_max ** (1 - p2) - gamma_break ** (1 - p2)
        ) / (1 - p2)
    elif p1_is_1 and not p2_is_1:
        t1 = math.log(gamma_break / gamma_min)
        t2 = gamma_break ** (p2 - 1.0) * (
            gamma_max ** (1 - p2) - gamma_break ** (1 - p2)
        ) / (1 - p2)
    elif not p1_is_1 and p2_is_1:
        t1 = (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
        t2 = gamma_break ** (1 - p1) * math.log(gamma_max / gamma_break)
    else:
        return 0.0
    return 1.0 / (t1 + t2)


def power_law_pdf(g, p, gamma_min, gamma_max):
    """n(g) = A g^-p inside the range, 0 outside (reference: electron.c:479-504)."""
    xp = xp_for(g)
    a = power_law_norm(p, gamma_min, gamma_max)
    val = a * g ** (-p)
    return xp.where((g >= gamma_min) & (g <= gamma_max), val, 0.0)


def broken_power_law_pdf(g, p1, p2, gamma_min, gamma_max, gamma_break):
    """Broken power law with continuity factor (reference: electron.c:374-406)."""
    xp = xp_for(g)
    a = broken_power_law_norm(p1, p2, gamma_min, gamma_max, gamma_break)
    cont = gamma_break ** (p2 - p1)
    val = xp.where(g <= gamma_break, a * g ** (-p1), a * cont * g ** (-p2))
    return xp.where((g >= gamma_min) & (g <= gamma_max), val, 0.0)


def norm_power_law_energy_dens(p, gamma_min, gamma_max):
    """<gamma m c^2> per electron for a power law (reference: electron.c:581-605)."""
    if abs(p - 2.0) < 1e-10:
        r = math.log(gamma_max / gamma_min)
    else:
        r = (gamma_max ** (2.0 - p) - gamma_min ** (2.0 - p)) / (2.0 - p)
    return r * power_law_norm(p, gamma_min, gamma_max) * ME_C2


def norm_broken_power_law_energy_dens(p1, p2, gamma_min, gamma_max, gamma_break):
    """<gamma m c^2> per electron, broken power law (reference: electron.c:607-652)."""
    p1_is_2 = abs(p1 - 2.0) < 1e-10
    p2_is_2 = abs(p2 - 2.0) < 1e-10
    if not p1_is_2 and not p2_is_2:
        t1 = (gamma_break ** (2 - p1) - gamma_min ** (2 - p1)) / (2 - p1)
        t2 = gamma_break ** (p2 - p1) * (
            gamma_max ** (2 - p2) - gamma_break ** (2 - p2)
        ) / (2 - p2)
        r = t1 + t2
    elif p1_is_2 and not p2_is_2:
        t1 = math.log(gamma_break / gamma_min)
        t2 = gamma_break ** (p2 - 2.0) * (
            gamma_max ** (2 - p2) - gamma_break ** (2 - p2)
        ) / (2 - p2)
        r = t1 + t2
    elif not p1_is_2 and p2_is_2:
        t1 = (gamma_break ** (2 - p1) - gamma_min ** (2 - p1)) / (2 - p1)
        t2 = gamma_break ** (2 - p1) * math.log(gamma_max / gamma_break)
        r = t1 + t2
    else:
        r = 0.0
    return r * broken_power_law_norm(p1, p2, gamma_min, gamma_max, gamma_break) * ME_C2


def power_law_cdf(g, p, gamma_min, gamma_max):
    """CDF of the normalized power law on [gamma_min, gamma_max]."""
    xp = xp_for(g)
    a = power_law_norm(p, gamma_min, gamma_max)
    if abs(p - 1.0) < 1e-10:
        return a * xp.log(g / gamma_min)
    return a * (g ** (1.0 - p) - gamma_min ** (1.0 - p)) / (1.0 - p)


def broken_power_law_cdf(g, p1, p2, gamma_min, gamma_max, gamma_break):
    """Piecewise CDF of the normalized broken power law (continuity factor
    gamma_break^(p2-p1) above the break; reference pdf: electron.c:374-406)."""
    xp = xp_for(g)
    a = broken_power_law_norm(p1, p2, gamma_min, gamma_max, gamma_break)

    def seg(lo, hi, p):
        if abs(p - 1.0) < 1e-10:
            return xp.log(hi / lo)
        return (hi ** (1.0 - p) - lo ** (1.0 - p)) / (1.0 - p)

    below = a * seg(gamma_min, xp.minimum(g, gamma_break), p1)
    cont = gamma_break ** (p2 - p1)
    f_break = a * seg(gamma_min, gamma_break, p1)
    above = a * cont * seg(gamma_break, xp.maximum(g, gamma_break), p2)
    return xp.where(g <= gamma_break, below, f_break + above)


# ---------------------------------------------------------------------------
# The XLA engine's samplers (mcrat_tpu.ops.electrons): each takes a threefry
# Key and splits it as JAX's does, so the same key draws the same electrons.
# Electron four-momenta are dimensionless (units of m_e c): el_p0 = gamma,
# |el_p| = gamma beta.
# ---------------------------------------------------------------------------


def sample_thermal_gamma_beta(key: Key, temp: torch.Tensor, max_iters: int = 12):
    """(gamma, gamma beta) from an exact Maxwell-Juttner at ``temp`` [K]
    (``mcrat_tpu.ops.electrons.sample_thermal_gamma_beta``, in place of
    sampleThermalElectron, Src/electron.c:202-237): in xi = (gamma - 1)/theta
    the density (1 + a) sqrt(a (2 + a)) e^-xi, a = theta xi, is bounded by the
    Exp(1), Gamma(2), Gamma(3) mixture [sqrt(theta)(1 + xi) + 2 theta^2 xi^2]
    e^-xi; a trial takes five uniforms and one log, and accepts >= 0.44 of
    draws at every temperature."""
    dtype = temp.dtype
    shape = tuple(temp.shape)
    theta = torch.clamp(KB_OVER_MEC2 * temp, min=torch.finfo(dtype).tiny)
    sqrt_theta = torch.sqrt(theta)
    # cumulative mixture weights over (Exp(1), Gamma(2), Gamma(3))
    m3 = 2.0 * theta * sqrt_theta
    inv_mass = 1.0 / (1.0 + m3)
    cum1 = 0.5 * inv_mass
    cum2 = inv_mass

    def propose(k):
        u = uniform_pos(k, shape + (5,), dtype)
        p2 = u[..., 0] * u[..., 1]
        um = u[..., 3]
        prod = torch.where(um < cum1, u[..., 0], torch.where(um < cum2, p2, p2 * u[..., 2]))
        return (-torch.log(prod), u[..., 4])

    def accept(xi, u_acc):
        a = theta * xi
        target = (1.0 + a) * torch.sqrt(torch.clamp(a * (2.0 + a), min=0.0))
        envelope = sqrt_theta * (1.0 + xi) + 2.0 * (theta * theta) * (xi * xi)
        return u_acc * envelope <= target

    xi, _ = batched_rejection(
        key, shape, propose, accept,
        init=(torch.full(shape, 1.5, dtype=dtype, device=temp.device),
              torch.zeros(shape, dtype=dtype, device=temp.device)),
        max_iters=max_iters)
    a = theta * xi
    return 1.0 + a, torch.sqrt(torch.clamp(a * (2.0 + a), min=0.0))


def sample_electron_cos_theta(key: Key, beta: torch.Tensor) -> torch.Tensor:
    """cos of the polar angle between electron and photon: the inverse CDF
    of (1 - beta cos t) sin t (Src/electron.c:196), cos t = (1 - sqrt(1 +
    beta^2 + 2 beta - 4 beta u)) / beta, with the beta -> 0 limit 2u - 1."""
    u = key.uniform(beta.shape, beta.dtype)
    safe_beta = torch.clamp(beta, min=1e-8)
    arg = 1.0 + safe_beta * safe_beta + 2.0 * safe_beta - 4.0 * safe_beta * u
    cos_t = (1.0 - torch.sqrt(torch.clamp(arg, min=0.0))) / safe_beta
    cos_t = torch.where(beta < 1e-6, 2.0 * u - 1.0, cos_t)
    return torch.clamp(cos_t, -1.0, 1.0)


def sample_electron_theta(key: Key, beta: torch.Tensor) -> torch.Tensor:
    """The polar angle between electron and photon."""
    return torch.arccos(sample_electron_cos_theta(key, beta))


def rotate_electron_to_photon_frame(el_p: torch.Tensor, ph_p: torch.Tensor) -> torch.Tensor:
    """Rotate electron momenta drawn about the photon's axis into the
    photon's frame (rotateElectron, reference: Src/electron.c:126-175), the
    rotation's cosines and sines taken from the photon's components: about y
    by theta = atan2(rho, p1), then about x by -phi = -atan2(p2, p3), rho =
    sqrt(p2^2 + p3^2); rho = 0 takes phi = 0."""
    tiny = torch.finfo(ph_p.dtype).tiny
    rho2 = ph_p[..., 2] * ph_p[..., 2] + ph_p[..., 3] * ph_p[..., 3]
    rho = torch.sqrt(rho2)
    inv_norm = 1.0 / torch.clamp(torch.sqrt(rho2 + ph_p[..., 1] * ph_p[..., 1]), min=tiny)
    c_th = ph_p[..., 1] * inv_norm
    s_th = rho * inv_norm
    safe_rho = torch.clamp(rho, min=tiny)
    c_ph = torch.where(rho > 0, ph_p[..., 3] / safe_rho, 1.0)
    s_ph = torch.where(rho > 0, ph_p[..., 2] / safe_rho, 0.0)
    v = rotate_about_x_cs(rotate_about_y_cs(el_p[..., 1:], c_th, s_th), c_ph, -s_ph)
    return torch.cat([el_p[..., :1], v], dim=-1)


def _electron_about_photon(k_phi: Key, k_th: Key, gamma, gb, beta, ph_p):
    """The electron four-momentum at Lorentz factor ``gamma`` (``gb`` =
    gamma beta), a uniform azimuth and the relative polar angle about the
    photon, rotated into the photon's frame."""
    phi = k_phi.uniform(gamma.shape, gamma.dtype, 0.0, 2.0 * math.pi)
    cos_t = sample_electron_cos_theta(k_th, beta)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    el_p = torch.stack([gamma, gb * cos_t, gb * sin_t * torch.sin(phi),
                        gb * sin_t * torch.cos(phi)], dim=-1)
    return rotate_electron_to_photon_frame(el_p, ph_p)


def sample_thermal_electron(key: Key, temp: torch.Tensor, ph_p: torch.Tensor) -> torch.Tensor:
    """Thermal electrons aligned to each photon (singleThermalElectron,
    reference: Src/electron.c:70-94): ``temp`` (N,) cell temperatures [K],
    ``ph_p`` (N, 4) comoving photon momenta (only their directions count).
    Returns (N, 4)."""
    k_g, k_phi, k_th = key.split(3)
    gamma, gb = sample_thermal_gamma_beta(k_g, temp)
    return _electron_about_photon(k_phi, k_th, gamma, gb, gb / gamma, ph_p)


def sample_power_law(key: Key, shape, dtype, p, gamma_min, gamma_max):
    """Inverse-CDF power law n(g) ~ g^-p on [gamma_min, gamma_max]
    (samplePowerLaw, Src/electron.c:253-270), with the p -> 1 limit."""
    u = uniform_pos(key, shape, dtype)
    if abs(p - 1.0) < 1e-6:
        return gamma_min * (gamma_max / gamma_min) ** u
    g = 1.0 + u * ((gamma_max / gamma_min) ** (1.0 - p) - 1.0)
    return gamma_min * g ** (1.0 / (1.0 - p))


def sample_broken_power_law(key: Key, shape, dtype, p1, p2, gamma_min, gamma_max,
                            gamma_break):
    """Inverse-CDF broken power law (sampleBrokenPowerLaw, Src/electron.c:
    272-332), with the reference's sign correction above the break
    (:289-292) and both p -> 1 limits."""
    u = uniform_pos(key, shape, dtype)
    p1_is_1 = abs(p1 - 1.0) < 1e-6
    p2_is_1 = abs(p2 - 1.0) < 1e-6
    if not p1_is_1 and not p2_is_1:
        a = 1.0 / (
            (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
            + gamma_break ** (p2 - p1) * (gamma_max ** (1 - p2) - gamma_break ** (1 - p2))
            / (1 - p2))
        xi_break = a * (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
        g_lo = (gamma_min ** (1 - p1) + (1 - p1) * u / a) ** (1.0 / (1 - p1))
        g_hi = (gamma_break ** (1 - p2) + (1 - p2) * gamma_break ** (p1 - p2) * (
            (gamma_min ** (1 - p1) - gamma_break ** (1 - p1)) / (1 - p1) + u / a)
        ) ** (1.0 / (1 - p2))
    elif p1_is_1 and not p2_is_1:
        a = 1.0 / (
            math.log(gamma_break / gamma_min)
            + gamma_break ** (p2 - p1) * (gamma_max ** (1 - p2) - gamma_break ** (1 - p2))
            / (1 - p2))
        xi_break = a * math.log(gamma_break / gamma_min)
        g_lo = gamma_min * torch.exp(u / a)
        g_hi = (gamma_break ** (1 - p2) - (1 - p2) * gamma_break ** (p1 - p2) * (
            math.log(gamma_break / gamma_min) - u / a)) ** (1.0 / (1 - p2))
    elif not p1_is_1 and p2_is_1:
        a = 1.0 / (
            (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
            + gamma_break ** (p2 - p1) * math.log(gamma_max / gamma_break))
        xi_break = a * (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)
        g_lo = (gamma_min ** (1 - p1) + (1 - p1) * u / a) ** (1.0 / (1 - p1))
        g_hi = gamma_break * torch.exp(gamma_break ** (p1 - p2) * (
            u / a - (gamma_break ** (1 - p1) - gamma_min ** (1 - p1)) / (1 - p1)))
    else:
        raise ValueError("p1 == p2 == 1 broken power law is not supported")
    return torch.where(u <= xi_break, g_lo, g_hi)


def sample_nonthermal_gamma_range(key: Key, g_lo, g_hi, cfg):
    """gamma from the configured nonthermal distribution restricted to
    per-lane subgroup ranges [g_lo, g_hi]: the inverse CDF at u' = F(g_lo) +
    u (F(g_hi) - F(g_lo)).  (The reference's restriction loop,
    Src/electron.c:102-105, can never trigger; this restricts.)"""
    u = uniform_pos(key, g_lo.shape, g_lo.dtype)
    if cfg.nonthermal_e_dist is NonthermalDist.POWERLAW:
        p = cfg.powerlaw_index
        f_lo = power_law_cdf(g_lo, p, cfg.gamma_min, cfg.gamma_max)
        f_hi = power_law_cdf(g_hi, p, cfg.gamma_min, cfg.gamma_max)
        up = f_lo + u * (f_hi - f_lo)
        a = power_law_norm(p, cfg.gamma_min, cfg.gamma_max)
        if abs(p - 1.0) < 1e-6:
            return cfg.gamma_min * torch.exp(up / a)
        return (cfg.gamma_min ** (1.0 - p) + (1.0 - p) * up / a) ** (1.0 / (1.0 - p))
    args = (cfg.powerlaw_index_1, cfg.powerlaw_index_2, cfg.gamma_min, cfg.gamma_max,
            cfg.gamma_break)
    f_lo = broken_power_law_cdf(g_lo, *args)
    f_hi = broken_power_law_cdf(g_hi, *args)
    return _broken_power_law_inverse(f_lo + u * (f_hi - f_lo), cfg)


def _broken_power_law_inverse(u, cfg):
    """Inverse CDF of the broken power law at the quantiles ``u``."""
    p1, p2 = cfg.powerlaw_index_1, cfg.powerlaw_index_2
    gmin, gmax, gbrk = cfg.gamma_min, cfg.gamma_max, cfg.gamma_break
    a = broken_power_law_norm(p1, p2, gmin, gmax, gbrk)

    def seg_int(lo, hi, p):
        if abs(p - 1.0) < 1e-10:
            return math.log(hi / lo)
        return (hi ** (1.0 - p) - lo ** (1.0 - p)) / (1.0 - p)

    f_break = a * seg_int(gmin, gbrk, p1)
    cont = gbrk ** (p2 - p1)
    if abs(p1 - 1.0) < 1e-6:
        g_lo = gmin * torch.exp(u / a)
    else:
        g_lo = (gmin ** (1.0 - p1) + (1.0 - p1) * u / a) ** (1.0 / (1.0 - p1))
    u2 = (u - f_break) / (a * cont)
    if abs(p2 - 1.0) < 1e-6:
        g_hi = gbrk * torch.exp(u2)
    else:
        g_hi = (gbrk ** (1.0 - p2) + (1.0 - p2) * u2) ** (1.0 / (1.0 - p2))
    return torch.where(u <= f_break, g_lo, g_hi)


def sample_nonthermal_electron(key: Key, subgroup: torch.Tensor, ph_p: torch.Tensor, cfg):
    """Nonthermal electrons aligned to each photon, from the chosen
    Lorentz-factor subgroup (1-based; singleNonThermalElectron, reference:
    Src/electron.c:96-124, and the subgroup interval at :55-62)."""
    k_g, k_phi, k_th = key.split(3)
    dtype = ph_p.dtype
    dg = (math.log10(cfg.gamma_max) - math.log10(cfg.gamma_min)) / cfg.n_gamma
    lg_lo = math.log10(cfg.gamma_min) + (subgroup - 1).to(dtype) * dg
    g_lo = torch.pow(10.0, lg_lo)
    g_hi = torch.pow(10.0, lg_lo + dg)
    gamma = sample_nonthermal_gamma_range(k_g, g_lo, g_hi, cfg)
    beta = torch.sqrt(torch.clamp(1.0 - 1.0 / (gamma * gamma), min=0.0))
    return _electron_about_photon(k_phi, k_th, gamma, gamma * beta, beta, ph_p)
