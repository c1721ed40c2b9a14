"""Special-relativistic four-vector operations (port of
``mcrat_tpu.ops.fourvec``).

Four-vectors carry a trailing axis of 4, (p0, p1, p2, p3) = (E/c, px, py, pz);
a boost takes the 3-velocity ``beta`` of the new frame measured in the old one
(boost by +beta takes lab -> comoving when beta is the fluid velocity).
Injection calls these on numpy float64 arrays; they take torch tensors too.
"""
from __future__ import annotations

import numpy as np
import torch

from .._xp import xp_for


def _cat(xp, parts):
    return np.concatenate(parts, axis=-1) if xp is np else torch.cat(parts, dim=-1)


def _sum_last(a):
    return a.sum(axis=-1, keepdims=True) if isinstance(a, np.ndarray) else a.sum(-1, keepdim=True)


def _tiny(a):
    return np.finfo(a.dtype).tiny if isinstance(a, np.ndarray) else torch.finfo(a.dtype).tiny


def lorentz_boost(beta, p, photon: bool = True):
    """Boost four-momenta ``p`` (..., 4) by 3-velocity ``beta`` (..., 3).

    Closed form of the matrix in reference Src/mclib.c:330-350:

        p0' = g (p0 - b . p)
        p'  = p + [(g - 1)(b . p)/b^2 - g p0] b

    |beta| == 0 returns the identity; ``photon`` re-imposes the null norm.
    """
    xp = xp_for(beta, p)
    b2 = _sum_last(beta * beta)
    safe_b2 = xp.where(b2 > 0, b2, 1.0)
    gamma = 1.0 / xp.sqrt(xp.maximum(1.0 - b2, 1e-30))
    p0 = p[..., :1]
    pv = p[..., 1:]
    bdotp = _sum_last(beta * pv)
    p0_new = gamma * (p0 - bdotp)
    coef = (gamma - 1.0) * bdotp / safe_b2 - gamma * p0
    pv_new = pv + coef * beta
    p0_new = xp.where(b2 > 0, p0_new, p0)
    pv_new = xp.where(b2 > 0, pv_new, pv)
    out = _cat(xp, [p0_new, pv_new])
    return zero_norm(out) if photon else out


def zero_norm(p):
    """Rescale the spatial part so its norm equals p0 (zeroNorm,
    reference: Src/mclib.c:409-434)."""
    xp = xp_for(p)
    pv = p[..., 1:]
    norm = xp.sqrt(_sum_last(pv * pv))
    scale = xp.where(norm > 0, p[..., :1] / xp.maximum(norm, _tiny(p)), 1.0)
    return _cat(xp, [p[..., :1], pv * scale])


# Rotations with the angle given as (cos, sin): the engine takes them from
# vector components, never from angles (mcrat_tpu.ops.fourvec; the scatter
# kernel's rot0/rot1, reference: Src/mcrat_scattering.c:247-283).


def rotate_about_z_cs(v, c, s):
    """Rotate 3-vectors (..., 3) about z by the angle of (cos, sin)."""
    return torch.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1],
                        v[..., 2]], dim=-1)


def rotate_about_y_cs(v, c, s):
    """Rotate 3-vectors about y (rot1's convention: x' = c x - s z)."""
    return torch.stack([c * v[..., 0] - s * v[..., 2], v[..., 1],
                        s * v[..., 0] + c * v[..., 2]], dim=-1)


def rotate_about_x_cs(v, c, s):
    """Rotate 3-vectors about x."""
    return torch.stack([v[..., 0], c * v[..., 1] - s * v[..., 2],
                        s * v[..., 1] + c * v[..., 2]], dim=-1)
