r"""Hot (energy/temperature-dependent) Compton cross sections (port of
``mcrat_tpu.ops.hot_xsec``).

The thermal table is sigma_hat(eps', theta) / sigma_T (Dolence+2009,
Canfield+1987; integrand: Src/hot_x_section.c:359-400),

    sigma_hat = 0.5 \int_1^{1+12 theta} dgamma \int_{-1}^{1} dmu
                n_MJ(gamma; theta) sigma_KN(eps' gamma (1 - mu beta)) (1 - mu beta),

on the reference grid (Src/hot_x_section.h:1-10: log10 eps' in [-12, 6] with
220 intervals, log10 theta in [-4, 4] with 80), evaluated by the same
Gauss-Legendre tensor quadrature as the JAX package, in float64 torch (on the
CPU by default).  The nonthermal table holds one column per gamma subgroup.

Tables are cached in the JAX package's npz format (same header, same
``CACHE_VERSION``), so a table either package built loads in the other.  The
port keeps every table in float64 on the host; :func:`interp_thermal`,
:func:`interp_nonthermal` and :func:`thermal_cheb_cells` move what they need
to the device of their arguments.

The fused-round kernel reads the thermal table through per-cell Chebyshev
rows (:func:`thermal_cheb_cells`) and, for nonthermal frames, one global
Chebyshev fit of the first subgroup (:func:`_sub1_cheb_static`).
"""
from __future__ import annotations

import dataclasses
import math
import os
import zipfile
from typing import Optional

import numpy as np
import torch

from ..config import Config, NonthermalDist
from ..constants import KB_OVER_MEC2
from ..device import resolve_device

from .compton import kn_cross_section
from .cyclosynch import electron_dist_subgroup_dens
from .electrons import broken_power_law_pdf, power_law_pdf
from .special import maxwell_juttner_pdf

# Reference grid constants (Src/hot_x_section.h:1-10)
LOG_PH_E_MIN = -12.0
LOG_PH_E_MAX = 6.0
N_PH_E = 220
LOG_T_MIN = -4.0
LOG_T_MAX = 4.0
N_T = 80

# log10 sigma_hat never falls below ~-11 on the table domain; an entry at the
# 1e-30 floor is an underflow artifact (a cache built in float32), not physics
_TABLE_SANITY_FLOOR = -20.0

# v3 of the JAX package's npz cache (float64 host build, 1e-30 floor)
CACHE_VERSION = 3


@dataclasses.dataclass
class HotCrossSectionTable:
    """Tables of log10(sigma_hat/sigma_T), float64 numpy on the host."""

    log_e: np.ndarray  # (N_PH_E + 1,) log10 eps'
    log_t: np.ndarray  # (N_T + 1,) log10 theta
    thermal: np.ndarray  # (N_PH_E + 1, N_T + 1)
    nonthermal: Optional[np.ndarray] = None  # (N_PH_E + 1, N_GAMMA)
    # fraction of the nonthermal distribution in each gamma subgroup
    # (reference: electron_dens_subgroup, Src/electron.c:655-675)
    subgroup_frac: Optional[np.ndarray] = None  # (N_GAMMA,)


def _boosted_xsec(eps, mu, gamma):
    """sigma_KN(eps gamma (1 - mu beta)) (1 - mu beta) (boostedCrossSection,
    reference: hot_x_section.c:370-400), float64 tensors."""
    beta = torch.sqrt(torch.clamp(gamma * gamma - 1.0, min=0.0)) / gamma
    doppler = 1.0 - mu * beta
    return kn_cross_section(eps * gamma * doppler) * doppler


def _gauss_legendre(n, a, b):
    x, w = np.polynomial.legendre.leggauss(n)
    x = 0.5 * (b - a) * x + 0.5 * (b + a)
    w = 0.5 * (b - a) * w
    return x, w


def _f64(a, device="cpu"):
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def build_thermal_table(n_gamma_nodes: int = 96, n_mu_nodes: int = 64,
                        device="cpu") -> tuple:
    """The (221, 81) thermal table by tensor-product Gauss-Legendre quadrature
    (calculateTotalThermalCrossSection over the grid, reference:
    hot_x_section.c:324-357): gamma over [1, 1 + 12 theta], mu over [-1, 1],
    in float64 torch on ``device``.  Returns numpy (log_e, log_t, log10
    table), float64, floored at 1e-30."""
    log_e = np.linspace(LOG_PH_E_MIN, LOG_PH_E_MAX, N_PH_E + 1)
    log_t = np.linspace(LOG_T_MIN, LOG_T_MAX, N_T + 1)
    mu_x, mu_w = _gauss_legendre(n_mu_nodes, -1.0, 1.0)
    g_x01, g_w01 = np.polynomial.legendre.leggauss(n_gamma_nodes)
    th = _f64(10.0**log_t, device)[:, None]  # (T, 1)
    gamma = 1.0 + 12.0 * th * _f64(0.5 * (g_x01 + 1.0), device)[None, :]  # (T, G)
    g_w = 12.0 * th * _f64(0.5 * g_w01, device)[None, :]
    mj = maxwell_juttner_pdf(gamma, th)
    mu, mu_w = _f64(mu_x, device)[None, None, :], _f64(mu_w, device)[None, None, :]
    rows = []
    for e in 10.0**log_e:
        val = _boosted_xsec(float(e), mu, gamma[..., None])  # (T, G, M)
        inner = torch.sum(val * mu_w, dim=-1)  # (T, G)
        rows.append(0.5 * torch.sum(mj * inner * g_w, dim=-1))
    table = torch.clamp(torch.stack(rows, dim=0), min=1e-30)
    return log_e, log_t, torch.log10(table).cpu().numpy()


def build_nonthermal_table(cfg: Config, n_gamma_nodes: int = 128, n_mu_nodes: int = 64,
                           device="cpu"):
    """Per-subgroup nonthermal tables (221, N_GAMMA) (calculateTotal
    NonThermalCrossSection, reference: hot_x_section.c:432-459): the
    full-range normalized (broken) power law over each log-spaced subgroup,
    in float64 torch on ``device``.  Returns numpy (log_e, log10 table)."""
    log_e = np.linspace(LOG_PH_E_MIN, LOG_PH_E_MAX, N_PH_E + 1)
    lg_min, lg_max = np.log10(cfg.gamma_min), np.log10(cfg.gamma_max)
    dg = (lg_max - lg_min) / cfg.n_gamma
    mu_x, mu_w = _gauss_legendre(n_mu_nodes, -1.0, 1.0)
    mu, mu_w = _f64(mu_x, device)[None, :], _f64(mu_w, device)[None, :]
    cols = []
    for i in range(cfg.n_gamma):
        g_lo, g_hi = 10.0 ** (lg_min + i * dg), 10.0 ** (lg_min + (i + 1) * dg)
        g_x, g_w = (_f64(a, device) for a in _gauss_legendre(n_gamma_nodes, g_lo, g_hi))
        if cfg.nonthermal_e_dist is NonthermalDist.POWERLAW:
            pdf = power_law_pdf(g_x, cfg.powerlaw_index, cfg.gamma_min, cfg.gamma_max)
        else:
            pdf = broken_power_law_pdf(g_x, cfg.powerlaw_index_1, cfg.powerlaw_index_2,
                                       cfg.gamma_min, cfg.gamma_max, cfg.gamma_break)
        col = []
        for e in 10.0**log_e:
            val = _boosted_xsec(float(e), mu, g_x[:, None])  # (G, M)
            inner = torch.sum(val * mu_w, dim=-1)
            col.append(0.5 * torch.sum(pdf * inner * g_w))
        cols.append(torch.stack(col))
    table = torch.clamp(torch.stack(cols, dim=-1), min=1e-30)
    return log_e, torch.log10(table).cpu().numpy()


# ---------------------------------------------------------------------------
# Disk cache (replaces the reference's text files + header validation,
# hot_x_section.c:852-1235)
# ---------------------------------------------------------------------------


def _cache_header(cfg: Config) -> dict:
    h = dict(
        version=CACHE_VERSION,
        log_e_min=LOG_PH_E_MIN,
        log_e_max=LOG_PH_E_MAX,
        n_e=N_PH_E,
        log_t_min=LOG_T_MIN,
        log_t_max=LOG_T_MAX,
        n_t=N_T,
        dist=cfg.nonthermal_e_dist.value,
    )
    if cfg.nonthermal_e_dist is not NonthermalDist.OFF:
        h.update(
            n_gamma=cfg.n_gamma,
            gamma_min=cfg.gamma_min,
            gamma_max=cfg.gamma_max,
            p=cfg.powerlaw_index or 0.0,
            p1=cfg.powerlaw_index_1 or 0.0,
            p2=cfg.powerlaw_index_2 or 0.0,
            gamma_break=cfg.gamma_break or 0.0,
        )
    return h


def load_or_build(cfg: Config, cache_path: Optional[str] = None,
                  device=None) -> HotCrossSectionTable:
    """Load the cached tables if the header matches the config (grid extents
    and distribution parameters, as validateThermalFile/validateNonthermalFile,
    reference: hot_x_section.c:852-1235), else build them (float64 on
    ``device``, default: the card) and write the cache (atomic
    write-then-swap)."""
    device = resolve_device(device)
    header = _cache_header(cfg)
    nonthermal = cfg.nonthermal_e_dist is not NonthermalDist.OFF
    data = None
    if cache_path and os.path.exists(cache_path):
        try:
            loaded = np.load(cache_path, allow_pickle=True)
            if (loaded["header"].item() == header
                    and np.asarray(loaded["thermal"]).min() > _TABLE_SANITY_FLOOR):
                data = {k: np.asarray(loaded[k], dtype=np.float64) for k in loaded.files
                        if k != "header"}
        except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile):
            data = None
    if data is None:
        log_e, log_t, thermal = build_thermal_table(device=device)
        data = dict(log_e=log_e, log_t=log_t, thermal=thermal)
        if nonthermal:
            data["nonthermal"] = build_nonthermal_table(cfg, device=device)[1]
        if cache_path:
            os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
            tmp = cache_path + ".tmp.npz"
            np.savez(tmp, header=np.asarray(header, dtype=object), **data)
            os.replace(tmp, cache_path)
    return HotCrossSectionTable(
        log_e=data["log_e"], log_t=data["log_t"], thermal=data["thermal"],
        nonthermal=data.get("nonthermal"),
        subgroup_frac=electron_dist_subgroup_dens(cfg) if nonthermal else None,
    )


# ---------------------------------------------------------------------------
# Interpolation (replaces the GSL bilinear 2-D spline, hot_x_section.c:545-605)
# ---------------------------------------------------------------------------


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _bilinear(table, x_grid, y_grid, x, y):
    """Bilinear interpolation of the (nx, ny) ``table`` on uniform grids at
    (x, y), edge-clamped; the four corners are plain gathers."""
    nx, ny = table.shape
    dx = x_grid[1] - x_grid[0]
    dy = y_grid[1] - y_grid[0]
    fx = torch.clamp((x - x_grid[0]) / dx, 0.0, nx - 1.000001)
    fy = torch.clamp((y - y_grid[0]) / dy, 0.0, ny - 1.000001)
    i0 = torch.floor(fx).to(torch.int64)
    j0 = torch.floor(fy).to(torch.int64)
    tx = fx - i0
    ty = fy - j0
    flat = table.reshape(-1)
    base = i0 * ny + j0
    v00, v01 = flat[base], flat[base + 1]
    v10, v11 = flat[base + ny], flat[base + ny + 1]
    return (
        v00 * (1 - tx) * (1 - ty)
        + v01 * (1 - tx) * ty
        + v10 * tx * (1 - ty)
        + v11 * tx * ty
    )


def direct_sigma_hat(e_comv, theta, n_gamma_nodes: int = 32, n_mu_nodes: int = 24):
    """Per-lane Gauss-Legendre evaluation of the hot cross-section integral
    over the [1, 1 + 12 theta] x [-1, 1] box: the out-of-table recompute
    (interpolateThermalHotCrossSection, reference: hot_x_section.c:545-605)."""
    gx01, gw01 = np.polynomial.legendre.leggauss(n_gamma_nodes)
    mu_x, mu_w = _gauss_legendre(n_mu_nodes, -1.0, 1.0)
    mu_x, mu_w = _on(mu_x, e_comv), _on(mu_w, e_comv)
    e, th = e_comv[:, None], theta[:, None]
    acc = torch.zeros_like(e_comv)
    for x01, w01 in zip(0.5 * (gx01 + 1.0), 0.5 * gw01):
        gamma = 1.0 + 12.0 * th * float(x01)
        mj = maxwell_juttner_pdf(gamma, th)
        beta = torch.sqrt(torch.clamp(gamma * gamma - 1.0, min=0.0)) / gamma
        doppler = 1.0 - mu_x * beta
        val = kn_cross_section(e * gamma * doppler).to(e.dtype) * doppler
        acc = acc + ((0.5 * 12.0) * th * float(w01) * mj * (val * mu_w).sum(-1, keepdim=True))[:, 0]
    return acc


def interp_thermal(table: HotCrossSectionTable, e_comv, temp):
    """sigma_hat/sigma_T for photons of comoving energy ``e_comv`` (units of
    m_e c^2) in cells at temperature ``temp`` [K], tensors of one dtype
    (interpolateThermalHotCrossSection + getThermalCrossSection, reference:
    Src/optical_depth.c:132-149, hot_x_section.c:545-605): bilinear in
    (log10 eps', log10 theta); below the theta floor the plain KN value;
    lanes past the high eps' or theta edge recompute the integral directly
    (:func:`direct_sigma_hat`, on those lanes only: eager PyTorch needs no
    fixed-size bucket, so none is capped)."""
    theta = KB_OVER_MEC2 * temp
    log_e = torch.log10(torch.clamp(e_comv, min=1e-300))
    log_th = torch.log10(torch.clamp(theta, min=1e-300))
    grid_e, grid_t = _on(table.log_e, e_comv), _on(table.log_t, e_comv)
    val = 10.0 ** _bilinear(_on(table.thermal, e_comv), grid_e, grid_t, log_e, log_th)
    oor = (log_e > grid_e[-1]) | (log_th > grid_t[-1])
    if bool(oor.any()):
        idx = torch.nonzero(oor.reshape(-1)).flatten()
        val = val.reshape(-1).clone()
        th_flat = torch.broadcast_to(theta, oor.shape).reshape(-1)
        e_flat = torch.broadcast_to(e_comv, oor.shape).reshape(-1)
        val[idx] = direct_sigma_hat(e_flat[idx], th_flat[idx])
        val = val.reshape(oor.shape)
    cold = theta < 10.0**LOG_T_MIN
    return torch.where(cold, kn_cross_section(e_comv).to(val.dtype), val)


def interp_nonthermal(table: HotCrossSectionTable, e_comv):
    """Per-subgroup sigma_hat/sigma_T, shape (N, N_GAMMA)
    (interpolateSubgroupNonThermalHotCrossSection, reference:
    hot_x_section.c; consumed at Src/optical_depth.c:151-168)."""
    nt = _on(table.nonthermal, e_comv)
    grid_e = _on(table.log_e, e_comv)
    log_e = torch.log10(torch.clamp(e_comv, min=1e-300))
    ne = nt.shape[0]
    dx = grid_e[1] - grid_e[0]
    fx = torch.clamp((log_e - grid_e[0]) / dx, 0.0, ne - 1.000001)
    i0 = torch.floor(fx).to(torch.int64)
    tx = (fx - i0)[..., None]
    return 10.0 ** (nt[i0] * (1 - tx) + nt[i0 + 1] * tx)


# ---------------------------------------------------------------------------
# Per-cell Chebyshev surrogate (in-kernel TABLE mode)
# ---------------------------------------------------------------------------

# Two-interval Chebyshev fit of log10 sigma_hat(eps') split at the per-cell
# KN knee s = -log10(1 + 12 theta): the LOW interval in linear
# x = eps' (1 + 12 theta) in [0, 1] at degree 5, the HIGH interval in
# log10 eps' over [s, LOG_PH_E_MAX] at degree 8 (worst-case relative sigma
# error 0.235% over the table, the JAX package's measurement), so the kernel
# evaluates sigma_hat every round from the photon's current comoving energy.
CHEB_DLO = 5  # low-interval degree (linear x-space)
CHEB_DHI = 8  # high-interval degree (log space)
CHEB_M = 32  # bilinear resampling nodes per interval
CHEB_ROWS = 1 + (CHEB_DLO + 1) + (CHEB_DHI + 1)  # inv-knee row + two coef sets


def _cheb_pinv(deg: int):
    x = np.cos(np.pi * (np.arange(CHEB_M) + 0.5) / CHEB_M)
    a = np.polynomial.chebyshev.chebvander(x, deg)
    return np.linalg.pinv(a), x


def thermal_cheb_cells(table: HotCrossSectionTable, temp_cells: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """(CHEB_ROWS, n_cells) per-cell sigma_hat surrogate rows, on the device
    of ``temp_cells`` [K].

    Row 0 is inv_knee = 10^-s = 1 + 12 theta (clipped to the table span);
    rows 1..1+CHEB_DLO are Chebyshev coefficients of log10 sigma_hat in
    t = 2 x - 1 with x = eps' inv_knee over [0, 1]; the remaining rows cover
    t = 2 log10(x) / (LOG_PH_E_MAX - s) - 1 above the knee.  Cells below the
    theta floor are fitted to the exact KN curve (reference:
    hot_x_section.c:336-340).

    Everything is computed in float64 from the float64 table and rounded
    once to ``dtype``.  The JAX package computes the rows in its table's
    dtype, float32 in bench.py, and so evaluates the cold branch's
    Klein-Nishina closed form in float32, which carries fault F6 (up to 0.25
    off just above eps' = 1e-3); here that branch is float64.
    """
    f64 = torch.float64
    temp = temp_cells.to(f64)
    pinv_lo, x_np = _cheb_pinv(CHEB_DLO)
    pinv_hi, _ = _cheb_pinv(CHEB_DHI)
    pinv_lo, pinv_hi, xs = (_on(a, temp) for a in (pinv_lo, pinv_hi, x_np))
    grid_e, grid_t = _on(table.log_e, temp), _on(table.log_t, temp)
    thermal = _on(table.thermal, temp)
    theta = KB_OVER_MEC2 * temp
    cold = theta < 10.0**LOG_T_MIN
    log_th = torch.log10(torch.clamp(theta, min=1e-30))
    lo_e, hi_e = float(table.log_e[0]), float(table.log_e[-1])
    s = torch.clamp(-torch.log10(1.0 + 12.0 * theta), lo_e + 1.0, hi_e - 1.0)

    def sample(le_nodes):
        vals = _bilinear(thermal, grid_e, grid_t, le_nodes,
                         torch.broadcast_to(log_th[None, :], le_nodes.shape))
        kn = torch.log10(torch.clamp(kn_cross_section(10.0**le_nodes), min=1e-30))
        return torch.where(cold[None, :], kn, vals)

    # low interval: nodes at x = (cos + 1) / 2 in (0, 1), at
    # log10 eps' = s + log10 x (clamped to the table floor)
    x_lo = 0.5 * (xs + 1.0)
    le_lo = torch.clamp(s[None, :] + torch.log10(torch.clamp(x_lo, min=1e-30))[:, None],
                        min=lo_e)
    c_lo = pinv_lo @ sample(le_lo)
    # high interval: log space [s, hi_e]
    le_hi = 0.5 * (hi_e - s)[None, :] * xs[:, None] + 0.5 * (hi_e + s)[None, :]
    c_hi = pinv_hi @ sample(le_hi)
    inv_knee = 10.0 ** (-s)
    return torch.cat([inv_knee[None, :], c_lo, c_hi], dim=0).to(dtype)


def _sub1_cheb_static(cfg: Config, log_e: np.ndarray, nt_col0: np.ndarray) -> tuple:
    """Global two-interval Chebyshev fit of sigma_sub for gamma subgroup 1.

    The biased multi-population optical depth collapses to tau0 (1 + N_GAMMA)
    where a cell has thermal electrons (reference: Src/optical_depth.c:60-112,
    177-183); sigma_sub of the FIRST subgroup is needed only for the tau_norm
    fallback of thermal-free cells, and is a function of eps' alone, so one
    global fit serves every cell.

    Layout: (f1, inv_knee, span_inv, c_lo[CHEB_DLO + 1], c_hi[CHEB_DHI + 1]),
    the same linear-x / log-space split as :func:`thermal_cheb_cells`, knee
    at eps' sqrt(g_lo g_hi) = 1.  Python floats (float64).
    """
    lgmin, lgmax = math.log10(cfg.gamma_min), math.log10(cfg.gamma_max)
    dg = (lgmax - lgmin) / cfg.n_gamma
    g_lo, g_hi = 10.0 ** lgmin, 10.0 ** (lgmin + dg)
    inv_knee = math.sqrt(g_lo * g_hi)
    s = -math.log10(inv_knee)
    x = 10.0 ** log_e * inv_knee
    lo = x < 1.0
    t_lo = 2.0 * np.clip(x, 0.0, 1.0) - 1.0
    t_hi = np.clip(2.0 * (log_e - s) / (log_e[-1] - s) - 1.0, -1.0, 1.0)
    c_lo, *_ = np.linalg.lstsq(
        np.polynomial.chebyshev.chebvander(t_lo[lo], CHEB_DLO), nt_col0[lo], rcond=None)
    c_hi, *_ = np.linalg.lstsq(
        np.polynomial.chebyshev.chebvander(t_hi[~lo], CHEB_DHI), nt_col0[~lo], rcond=None)
    f1 = float(electron_dist_subgroup_dens(cfg)[0])
    span_inv = 1.0 / (log_e[-1] - s)
    return (f1, float(inv_knee), float(span_inv),
            *(float(v) for v in c_lo), *(float(v) for v in c_hi))
