"""Nonthermal electron distributions (part of ``mcrat_tpu.ops.electrons``).

The host functions a nonthermal frame needs: the power-law and broken
power-law normalizations, pdfs, CDFs and mean energies (reference:
Src/electron.c:334-652).  Normalizations are Python floats; pdfs and CDFs
take numpy arrays or torch tensors.  The in-kernel samplers are in
``ops.fused_round``; the XLA-path samplers are ROADMAP queue 1 item 5.
"""
from __future__ import annotations

import math

from ..constants import ME_C2

from .._xp import xp_for


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
