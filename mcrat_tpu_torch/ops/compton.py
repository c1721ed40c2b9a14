"""Klein-Nishina total cross section (part of ``mcrat_tpu.ops.compton``).

Only :func:`kn_cross_section`, the batched float64 host function of the hot
cross-section table build and of the Chebyshev rows' cold branch
(``ops.hot_xsec``).  The rest of that module (the XLA-path scatter) is
ROADMAP queue 1 item 5.
"""
from __future__ import annotations

import numpy as np
import torch

from .._xp import xp_for


def kn_cross_section(energy_ratio):
    """sigma_KN / sigma_T in float64 (kleinNishinaCrossSection, reference:
    Src/mcrat_scattering.c:597-623): the closed form above e = 1e-3, the
    linear Taylor limit 1 - 2 e below.  Takes a numpy array or a torch
    tensor and returns float64 of the same kind: in float64 the closed form
    keeps ~1e-10 of its ~2/e^2 cancellation at the switch, where float32 loses
    up to 0.25 (ROADMAP fault F6)."""
    xp = xp_for(energy_ratio)
    e = (energy_ratio.to(torch.float64) if torch.is_tensor(energy_ratio)
         else np.asarray(energy_ratio, dtype=np.float64))
    safe_e = xp.maximum(e, 1e-10)
    full = 0.75 * (
        2.0 / (safe_e * safe_e)
        + (1.0 / (2.0 * safe_e) - (1.0 + safe_e) / (safe_e * (safe_e * safe_e)))
        * xp.log1p(2.0 * safe_e)
        + (1.0 + safe_e) / ((1.0 + 2.0 * safe_e) * (1.0 + 2.0 * safe_e))
    )
    return xp.where(e >= 1e-3, full, 1.0 - 2.0 * e)
