"""Serial-equivalent transport: the reference's exact event ordering (port of
``mcrat_tpu.serial``).

The batched engines advance every photon through its own free-path chain
concurrently; the reference instead orders events globally: sample *all*
free paths, walk the candidates from the smallest, advance the whole
population to each candidate's time, scatter that one photon, then resample
everything (Src/mclib.c:617-714, 1107-1356).  The two are equivalent in
distribution (exponential memorylessness); this module runs the reference
ordering directly -- O(N) work an event, the ordering on the host in numpy,
the per-photon physics as torch ops on the photons' device -- as the
validation oracle for that claim and as a debugging tool for small
populations.  With the same threefry key it draws the JAX package's numbers
(``ops.prng.Key``), so in float64 it follows ``mcrat_tpu.serial`` event for
event.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import scipy.special
import torch

from .config import Config, NonthermalDist, PhotonType, TauCalculation
from .constants import C_LIGHT, KB_OVER_MEC2, M_P, THOM_X_SECT
from .grid import find_cell_rows, gather_rows
from .ops import compton, electrons
from .ops.fourvec import lorentz_boost
from .ops.prng import Key
from .ops.stokes import stokes_rotation
from .transport import DEFAULT_MFP, Photons, _tau_rate


# ---------------------------------------------------------------------------
# Independent hot-cross-section / biased-population machinery (numpy).
#
# The batched engine's TABLE + nonthermal path rests on ops.hot_xsec
# (Gauss-Legendre tensor quadrature -> bilinear table -> Chebyshev surrogate)
# and transport._tau_rate's bias bookkeeping; a fault shared by those would
# be invisible to comparisons between the engines.  Everything below
# re-derives sigma_hat and the generateSingleElectron ordering from the
# published formulas with plain numpy trapezoid quadrature and inverse-CDF
# sampling -- no code shared with ops.hot_xsec or _tau_rate.  Reference:
# Src/hot_x_section.c:324-459 (integrals), Src/optical_depth.c:60-112
# (biased multi-population tau), Src/electron.c:7-68 (population pick).
# ---------------------------------------------------------------------------


def _sigma_kn_np(e):
    """Total KN cross section / sigma_T, closed form (grmonty style;
    reference: kleinNishinaCrossSection, Src/mcrat_scattering.c:597-623)."""
    e = np.asarray(e, np.float64)
    small = e < 1e-3
    es = np.where(small, 1.0, e)
    full = 0.75 * (
        2.0 / (es * es)
        + (1.0 / (2.0 * es) - (1.0 + es) / es**3) * np.log1p(2.0 * es)
        + (1.0 + es) / (1.0 + 2.0 * es) ** 2
    )
    return np.where(small, 1.0 - 2.0 * e, full)


def _k2e_np(x):
    """The scaled modified Bessel function K2(x) e^x (scipy's ``kve``,
    independent of ``ops.special``), finite for cold cells.  The JAX
    package's oracle integrates the cosh form on a fixed t-grid instead,
    which the integrand's width sqrt(2 / x) outruns in cells colder than a
    few K (fault F4, not copied)."""
    return scipy.special.kve(2, np.asarray(x, np.float64))


def _sigma_hat_thermal_np(eps, theta, n_g=96, n_mu=64):
    """sigma_hat(eps', theta): MJ-averaged KN over the reference's
    [1, 1+12 theta] x [-1, 1] box, trapezoid rule."""
    eps = np.atleast_1d(np.asarray(eps, np.float64))
    theta = np.atleast_1d(np.asarray(theta, np.float64))
    x = np.linspace(0.0, 1.0, n_g)[None, :, None]         # (1, G, 1)
    mu = np.linspace(-1.0, 1.0, n_mu)[None, None, :]      # (1, 1, M)
    th = theta[:, None, None]
    g = 1.0 + 12.0 * th * x                               # (N, G, 1)
    beta = np.sqrt(np.maximum(1.0 - 1.0 / (g * g), 0.0))
    # n_MJ(g) = g^2 beta exp(-g/th) / (th K2(1/th)), written against the
    # scaled Bessel function so exp(-g/th)/exp(-1/th) = exp((1-g)/th) stays
    # finite down to cold cells
    mj = (
        g * np.sqrt(np.maximum(g * g - 1.0, 0.0))
        * np.exp((1.0 - g) / th)
        / (th * _k2e_np(1.0 / theta)[:, None, None])
    )
    integrand = 0.5 * mj * _sigma_kn_np(eps[:, None, None] * g * (1.0 - mu * beta)) * (
        1.0 - mu * beta
    )
    inner = np.trapezoid(integrand, np.broadcast_to(mu, integrand.shape), axis=-1)
    return np.trapezoid(inner, np.broadcast_to(g[..., 0], inner.shape), axis=-1)


def _subgroup_bounds_np(cfg: Config):
    lg = np.linspace(np.log10(cfg.gamma_min), np.log10(cfg.gamma_max), cfg.n_gamma + 1)
    return 10.0 ** lg


def _subgroup_frac_np(cfg: Config, n_g=4001):
    """Number fraction of the power-law distribution per gamma subgroup
    (reference: calculateElectronDistSubgroupDens, Src/electron.c:655-675)."""
    if cfg.powerlaw_index is None:
        raise ValueError("the serial oracle's nonthermal machinery covers POWERLAW")
    p = cfg.powerlaw_index
    g = np.geomspace(cfg.gamma_min, cfg.gamma_max, n_g)
    pdf = g ** (-p)
    total = np.trapezoid(pdf, g)
    bounds = _subgroup_bounds_np(cfg)
    out = []
    for i in range(cfg.n_gamma):
        m = (g >= bounds[i]) & (g <= bounds[i + 1])
        out.append(np.trapezoid(pdf[m], g[m]) / total)
    return np.asarray(out)


def _sigma_hat_subgroup_np(eps, cfg: Config, i: int, n_g=96, n_mu=64):
    """Power-law-averaged KN over subgroup i's gamma interval."""
    eps = np.atleast_1d(np.asarray(eps, np.float64))
    p = cfg.powerlaw_index
    bounds = _subgroup_bounds_np(cfg)
    g = np.geomspace(bounds[i], bounds[i + 1], n_g)[None, :, None]
    mu = np.linspace(-1.0, 1.0, n_mu)[None, None, :]
    beta = np.sqrt(np.maximum(1.0 - 1.0 / (g * g), 0.0))
    pdf = g ** (-p)
    norm = np.trapezoid(pdf[0, :, 0], g[0, :, 0])
    integrand = 0.5 * (pdf / norm) * _sigma_kn_np(
        eps[:, None, None] * g * (1.0 - mu * beta)
    ) * (1.0 - mu * beta)
    inner = np.trapezoid(integrand, np.broadcast_to(mu, integrand.shape), axis=-1)
    return np.trapezoid(inner, np.broadcast_to(g[..., 0], inner.shape), axis=-1)


def _np(x):
    return x.detach().cpu().numpy()


def _independent_tau_rate(cfg: Config, frame, photons: Photons, cell, comv, fluid_beta,
                          break_bias: bool = False, cache=None):
    """Biased multi-population tau rate, re-derived with numpy.

    Returns (rate, tau0, tau_i, bias_i) as numpy arrays.  ``break_bias=True``
    drops the bias_i tau_i == tau_norm collapse (bias_i = 1): the deliberate
    defect the oracle-vs-batched equivalence test must detect at 3 sigma.

    ``cache`` (a dict the caller carries across events) memoizes the
    quadrature sigma_hats per photon keyed on (eps', theta): between serial
    events only the one scattered photon's comoving energy changes (plus any
    photons whose cell temperature changed), so the O(N x nodes) quadrature
    collapses to O(changed lanes) after the first event.
    """
    safe = np.clip(_np(cell), 0, frame.num_elements - 1)
    dens_lab = _np(frame.dens_lab)[safe]
    temp = _np(frame.temp)[safe]
    gam = _np(frame.gamma)[safe]
    nt_dens = _np(frame.nonthermal_dens)[safe]
    fb = _np(fluid_beta)
    pv = _np(photons.p[:, 1:])
    fl_norm = np.linalg.norm(fb, axis=-1)
    ph_norm = np.linalg.norm(pv, axis=-1)
    cos_ang = np.sum(fb * pv, axis=-1) / np.maximum(fl_norm * ph_norm, 1e-300)
    beta = np.sqrt(np.maximum(1.0 - 1.0 / (gam * gam), 0.0))
    fluid_factor = 1.0 - beta * cos_ang
    eps = _np(comv[:, 0]).astype(np.float64)
    theta_e = KB_OVER_MEC2 * temp

    with_nt = cfg.nonthermal_e_dist is not NonthermalDist.OFF
    if cache is not None and "eps" in cache:
        stale = (eps != cache["eps"]) | (theta_e != cache["th"])
        sig0 = cache["sig0"]
        if stale.any():
            sig0[stale] = _sigma_hat_thermal_np(eps[stale], theta_e[stale])
            if with_nt:
                for i in range(cfg.n_gamma):
                    cache["sig_sub"][stale, i] = _sigma_hat_subgroup_np(eps[stale], cfg, i)
    else:
        sig0 = _sigma_hat_thermal_np(eps, theta_e)
        if cache is not None:
            cache["sig0"] = sig0
            if with_nt:
                cache["sig_sub"] = np.stack(
                    [_sigma_hat_subgroup_np(eps, cfg, i) for i in range(cfg.n_gamma)],
                    axis=-1)
    if cache is not None:
        cache["eps"] = eps.copy()
        cache["th"] = theta_e.copy()

    n_e_lab = dens_lab / M_P
    tau0 = n_e_lab * THOM_X_SECT * sig0 * fluid_factor

    if not with_nt:
        return tau0, tau0, None, None
    frac = _subgroup_frac_np(cfg)
    if cache is not None and "sig_sub" in cache:
        sig_sub = cache["sig_sub"]
    else:
        sig_sub = np.stack([_sigma_hat_subgroup_np(eps, cfg, i) for i in range(cfg.n_gamma)],
                           axis=-1)
    n_nt_lab = nt_dens * gam
    tau_i = n_nt_lab[:, None] * frac[None, :] * THOM_X_SECT * sig_sub * fluid_factor[:, None]
    tau_norm = np.where(tau0 > 0, tau0, tau_i[:, 0])
    if break_bias:
        bias_i = np.ones_like(tau_i)
    else:
        bias_i = tau_norm[:, None] / np.maximum(tau_i, 1e-300)
    rate = tau0 + np.sum(bias_i * tau_i, axis=-1)
    return rate, tau0, tau_i, bias_i


class SerialResult(NamedTuple):
    photons: Photons
    n_scatt: int
    n_events_attempted: int
    # frame time actually consumed (== dt_max unless max_events capped the
    # walk); scattering RATES need it: a broken bias changes the event tempo
    # by orders of magnitude, so equal-count comparisons deadlock
    t_advanced: float = 0.0


def transport_frame_serial(
    cfg: Config,
    photons: Photons,
    frame,
    index,
    dt_max: float,
    key: Key,
    xsec_table=None,
    stokes_on: bool = True,
    max_events: int = 10_000_000,
    break_bias: bool = False,
) -> SerialResult:
    """One frame window with the reference's global-min-time event loop
    (``mcrat_tpu.serial.transport_frame_serial``), on the photons' device;
    ``key`` a threefry :class:`~mcrat_tpu_torch.ops.prng.Key`.

    In TABLE mode (``cfg.tau_calculation``) the tau rates, subgroup optical
    depths, scattering biases and the generateSingleElectron population pick
    all come from the independent numpy machinery above: the oracle shares
    no rate or cross-section code with the batched engines there.
    ``break_bias`` injects the deliberate bias defect for the discrimination
    test.  ``photons`` is not modified.
    """
    device = photons.device
    rng_key = Key(key.data.to(device))
    t_remaining = float(dt_max)
    n_scatt = 0
    attempts = 0
    use_indep = cfg.tau_calculation is TauCalculation.TABLE
    sig_cache = {}
    rng_np = np.random.default_rng(int(rng_key.fold_in(40507).randint((), 0, 2**31 - 1)))
    photons = Photons(**{k: v.clone() for k, v in photons.fields().items()})

    while t_remaining > 0 and attempts < max_events:
        rng_key, k_mfp, k_el, k_sc = rng_key.split(4)
        # 1. cells + rates + free paths for everyone (calcMeanFreePath)
        pop_parts = None
        if use_indep:
            # geometry (fluid beta) is shared, separately validated code; the
            # rate itself is the independent quadrature path
            cell, _, fluid_beta, comv = _event_setup(cfg, photons, frame, index, None)
            photons.cell = cell
            rate_np, tau0, tau_i, bias_i = _independent_tau_rate(
                cfg, frame, photons, cell, comv, fluid_beta, break_bias=break_bias,
                cache=sig_cache)
            if tau_i is not None:
                pop_parts = (tau0, tau_i, bias_i)
        else:
            cell, rate, fluid_beta, comv = _event_setup(cfg, photons, frame, index, xsec_table)
            photons.cell = cell
            rate_np = _np(rate)
        alive = _np(photons.alive)
        in_grid = _np(cell) >= 0
        u = _np(k_mfp.uniform((photons.capacity,), photons.p.dtype))
        u = np.maximum(u, np.finfo(np.float64).tiny)
        mfp = np.where(in_grid, -np.log(u) / np.maximum(rate_np, 1e-300), DEFAULT_MFP)
        t_scatt = mfp / C_LIGHT
        t_scatt = np.where(alive, t_scatt, np.inf)

        # 2. walk candidates in time order (photonEvent)
        order = np.argsort(t_scatt)
        consumed = 0.0
        event_done = False
        for idx in order:
            attempts += 1
            t_cand = float(t_scatt[idx])
            if t_cand >= t_remaining or not np.isfinite(t_cand):
                # advance everyone to the frame boundary and finish
                _advance_all(photons, t_remaining - consumed)
                consumed = t_remaining
                event_done = True
                break
            # advance ALL photons to this candidate's time
            _advance_all(photons, t_cand - consumed)
            consumed = t_cand
            # attempt the single scattering
            ok = _attempt_one(cfg, photons, frame, int(idx), fluid_beta, comv,
                              k_sc.fold_in(int(idx)), stokes_on, pop_parts=pop_parts,
                              rng_np=rng_np)
            if ok:
                n_scatt += 1
                event_done = True
                break
        t_remaining -= consumed
        if not event_done:
            break
    return SerialResult(photons=photons, n_scatt=n_scatt, n_events_attempted=attempts,
                        t_advanced=float(dt_max) - t_remaining)


def _advance_all(photons: Photons, dt: float) -> None:
    """Every live photon but the pool's moved along its direction at c for
    ``dt`` (in place)."""
    if dt <= 0:
        return
    moves = photons.alive & (photons.ptype != int(PhotonType.CS_POOL))
    inv_p0 = 1.0 / torch.clamp(photons.p[:, 0], min=1e-300)
    step = photons.p[:, 1:] * inv_p0[:, None] * (C_LIGHT * dt)
    photons.pos = torch.where(moves[:, None], photons.pos + step, photons.pos)


def _event_setup(cfg: Config, photons: Photons, frame, index, xsec_table):
    """Cells, the engines' tau rate (DIRECT, or TABLE from the shared
    tables; unused on the independent path), fluid beta and comoving
    momenta of one event iteration."""
    cell, _ = find_cell_rows(cfg, index, frame, photons.pos, photons.cell, all_lanes=True)
    ph = photons.replace(cell=cell)
    rate, fluid_beta, _ = _tau_rate(cfg, ph, gather_rows(frame, cell), xsec_table)
    comv = lorentz_boost(fluid_beta, ph.p, photon=True)
    return cell, rate, fluid_beta, comv


def _attempt_core(cfg: Config, photons: Photons, frame, idx: int, fluid_beta, comv, key: Key,
                  stokes_on: bool, gamma_sub=None) -> bool:
    """The torch half of one scatter attempt of photon ``idx``, written into
    ``photons`` in place when accepted.  With ``gamma_sub`` the electron's
    Lorentz factor comes in precomputed (the oracle's independent host-side
    inverse-CDF draw) and only its angles are drawn here."""
    k_el, k_sc, k_th, k_phi = key.split(4)
    take = slice(idx, idx + 1)
    comv_i, beta_i = comv[take], fluid_beta[take]
    p_i, s_i = photons.p[take], photons.s[take]
    if stokes_on:
        s_i = stokes_rotation(beta_i, p_i[:, 1:], comv_i[:, 1:], s_i)
    if gamma_sub is not None:
        gamma = torch.full((1,), gamma_sub, dtype=comv_i.dtype, device=comv_i.device)
        beta_e = torch.sqrt(torch.clamp(1.0 - 1.0 / (gamma * gamma), min=0.0))
        cos_t = electrons.sample_electron_cos_theta(k_th, beta_e)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = k_phi.uniform((1,), comv_i.dtype, 0.0, 2.0 * math.pi)
        gb = gamma * beta_e
        el = torch.stack([gamma, gb * cos_t, gb * sin_t * torch.sin(phi),
                          gb * sin_t * torch.cos(phi)], dim=-1)
        el = electrons.rotate_electron_to_photon_frame(el, comv_i)
    else:
        safe = torch.clamp(photons.cell[take], 0, frame.num_elements - 1).to(torch.int64)
        el = electrons.sample_thermal_electron(k_el, frame.temp[safe], comv_i)
    res = compton.single_scatter(k_sc, el, comv_i, s_i, stokes_on=stokes_on)
    if not bool(res.scattered[0]):
        return False
    new_lab = lorentz_boost(-beta_i, res.ph_p, photon=True)
    s_new = (stokes_rotation(-beta_i, res.ph_p[:, 1:], new_lab[:, 1:], res.s) if stokes_on
             else res.s)
    photons.p[take] = new_lab.to(photons.p.dtype)
    photons.comv_p[take] = res.ph_p.to(photons.p.dtype)
    photons.s[take] = s_new.to(photons.s.dtype)
    photons.num_scatt[take] += 1.0
    if int(photons.ptype[idx]) == int(PhotonType.CS_POOL):
        photons.ptype[take] = int(PhotonType.COMPTONIZED)
    return True


def _attempt_one(cfg: Config, photons: Photons, frame, idx: int, fluid_beta, comv, key: Key,
                 stokes_on: bool, pop_parts=None, rng_np=None) -> bool:
    """Attempt the scattering of photon ``idx`` (photonEvent's inner step).

    With ``pop_parts`` = (tau0, tau_i, bias_i) the scattering electron's
    population is picked from the biased cumulative optical depths: the
    reference's generateSingleElectron ordering (Src/electron.c:7-68, with a
    proper uniform draw; the reference carries a leftover testing override
    random_num = 0.6 at :21).  The population pick and the subgroup gamma
    draw run on the host (an independent numpy inverse-CDF of the power law
    restricted to the subgroup interval, reference: samplePowerLaw,
    Src/electron.c:253-270).
    """
    sub = None
    if pop_parts is not None:
        tau0, tau_i, bias_i = pop_parts
        weights = np.concatenate([[float(tau0[idx])], bias_i[idx] * tau_i[idx]])
        total = weights.sum()
        u_pop = rng_np.random()
        pick = int(np.searchsorted(np.cumsum(weights) / total, u_pop))
        if pick > 0:
            sub = min(pick - 1, cfg.n_gamma - 1)
    gamma_sub = None
    if sub is not None:
        p = cfg.powerlaw_index
        b = _subgroup_bounds_np(cfg)
        u = rng_np.random()
        if abs(p - 1.0) < 1e-12:
            gamma_sub = b[sub] * (b[sub + 1] / b[sub]) ** u
        else:
            a = 1.0 - p
            gamma_sub = (b[sub] ** a + u * (b[sub + 1] ** a - b[sub] ** a)) ** (1.0 / a)
    return _attempt_core(cfg, photons, frame, idx, fluid_beta, comv, key, stokes_on,
                         gamma_sub)
