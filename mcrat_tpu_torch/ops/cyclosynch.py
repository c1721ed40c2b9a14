"""Magnetic field and nonthermal electron densities (part of
``mcrat_tpu.ops.cyclosynch``).

Only what sets up a nonthermal frame: the equipartition B field, the
nonthermal electron density per cell and the subgroup fractions of the
distribution (host numpy, float64).  Cyclo-synchrotron emission, absorption
and rebinning are ROADMAP queue 1 item 11.
"""
from __future__ import annotations

import math

import numpy as np

from ..config import BFieldCalc, Config, NonthermalDist
from ..constants import A_RAD, C_LIGHT, K_B, KB_OVER_MEC2, M_P

from .._xp import xp_for
from .electrons import (
    broken_power_law_pdf,
    norm_broken_power_law_energy_dens,
    norm_power_law_energy_dens,
    power_law_pdf,
)


def dimless_theta(temp):
    """k T / m_e c^2 (reference: calcDimlessTheta, Src/mc_cyclosynch.c:48-52)."""
    return KB_OVER_MEC2 * temp


def calc_b(cfg: Config, el_dens, temp):
    """Equipartition B field (reference: calcB, Src/mc_cyclosynch.c:54-76).

    INTERNAL_E: B = sqrt(eps_B 8 pi (3/2) n_e k T);
    TOTAL_E:    B = sqrt(8 pi eps_B (n_e m_p c^2 + 4 a T^4 / 3)).
    """
    xp = xp_for(el_dens, temp)
    if cfg.b_field_calc is BFieldCalc.INTERNAL_E:
        return xp.sqrt(cfg.epsilon_b * 8.0 * math.pi * 3.0 * el_dens * K_B * temp / 2.0)
    if cfg.b_field_calc is BFieldCalc.TOTAL_E:
        return xp.sqrt(
            8.0 * math.pi * cfg.epsilon_b
            * (el_dens * M_P * C_LIGHT**2 + 4.0 * A_RAD * temp**4 / 3.0)
        )
    raise ValueError("calc_b called with B_FIELD_CALC == SIMULATION")


def b_magnitude(cfg: Config, frame, idx=None):
    """|B| per cell (reference: getMagneticFieldMagnitude, mc_cyclosynch.c:78-92)."""
    xp = xp_for(frame.dens)
    if idx is None:
        dens, temp = frame.dens, frame.temp
        b0, b1, b2 = frame.B0, frame.B1, frame.B2
    else:
        dens, temp = frame.dens[idx], frame.temp[idx]
        b0, b1, b2 = frame.B0[idx], frame.B1[idx], frame.B2[idx]
    if cfg.b_field_calc is BFieldCalc.SIMULATION:
        return xp.sqrt(b0 * b0 + b1 * b1 + b2 * b2)
    return calc_b(cfg, dens / M_P, temp)


def nonthermal_electron_dens(cfg: Config, host) -> np.ndarray:
    """n_e,nonthermal = B^2 / (8 pi <gamma m c^2>) per cell of a
    :class:`~mcrat_tpu_torch.grid.HydroFrameHost` (reference:
    calculateNonthermalElectronDens, Src/electron.c:677-706)."""
    if cfg.nonthermal_e_dist is NonthermalDist.POWERLAW:
        e_per = norm_power_law_energy_dens(cfg.powerlaw_index, cfg.gamma_min, cfg.gamma_max)
    else:
        e_per = norm_broken_power_law_energy_dens(
            cfg.powerlaw_index_1, cfg.powerlaw_index_2,
            cfg.gamma_min, cfg.gamma_max, cfg.gamma_break,
        )
    b = np.asarray(b_magnitude(cfg, host))
    return b * b / (8.0 * math.pi * e_per)


def electron_dist_subgroup_dens(cfg: Config) -> np.ndarray:
    """Fraction of the nonthermal distribution in each gamma subgroup
    (reference: calculateElectronDistSubgroupDens, Src/electron.c:655-675),
    by 256-node Gauss-Legendre quadrature instead of QAGS."""
    lgmin, lgmax = math.log10(cfg.gamma_min), math.log10(cfg.gamma_max)
    dg = (lgmax - lgmin) / cfg.n_gamma
    out = np.zeros(cfg.n_gamma)
    x01, w01 = np.polynomial.legendre.leggauss(256)
    for i in range(cfg.n_gamma):
        g_lo, g_hi = 10.0 ** (lgmin + i * dg), 10.0 ** (lgmin + (i + 1) * dg)
        x = 0.5 * (g_hi - g_lo) * x01 + 0.5 * (g_hi + g_lo)
        w = 0.5 * (g_hi - g_lo) * w01
        if cfg.nonthermal_e_dist is NonthermalDist.POWERLAW:
            pdf = power_law_pdf(x, cfg.powerlaw_index, cfg.gamma_min, cfg.gamma_max)
        else:
            pdf = broken_power_law_pdf(
                x, cfg.powerlaw_index_1, cfg.powerlaw_index_2,
                cfg.gamma_min, cfg.gamma_max, cfg.gamma_break,
            )
        out[i] = float(np.sum(pdf * w))
    return out
