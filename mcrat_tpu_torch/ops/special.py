"""Special functions of the hot cross-section build (port of
``mcrat_tpu.ops.special``).

Exponentially scaled modified Bessel functions K0e/K1e from the Abramowitz &
Stegun 9.8.5-9.8.8 polynomial fits (|err| < 2e-7), K2e from the recurrence
K2 = K0 + (2/z) K1, and the normalized Maxwell-Juttner distribution
(reference: Src/electron.c:221,538-560).  Each takes numpy arrays or torch
tensors and keeps the JAX package's operation order, so the float64 table
build agrees with it to rounding.
"""
from __future__ import annotations

import math

from .._xp import xp_for


def _poly(x, coeffs):
    xp = xp_for(x)
    r = xp.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        r = r * x + c
    return r


def _tiny(z):
    return xp_for(z).finfo(z.dtype).tiny


def bessel_k0e(z):
    """exp(z) * K0(z), z > 0."""
    xp = xp_for(z)
    t = z * z / 4.0
    small_i0 = _poly(
        (z / 3.75) ** 2,
        [0.0045813, 0.0360768, 0.2659732, 1.2067492, 3.0899424, 3.5156229, 1.0],
    )
    small = (
        -xp.log(xp.maximum(z, _tiny(z)) / 2.0) * small_i0
        + _poly(
            t,
            [0.00000740, 0.00010750, 0.00262698, 0.03488590, 0.23069756, 0.42278420, -0.57721566],
        )
    ) * xp.exp(z)
    u = 2.0 / z
    large = _poly(
        u,
        [0.00053208, -0.00251540, 0.00587872, -0.01062446, 0.02189568, -0.07832358, 1.25331414],
    ) / xp.sqrt(z)
    return xp.where(z <= 2.0, small, large)


def bessel_k1e(z):
    """exp(z) * K1(z), z > 0."""
    xp = xp_for(z)
    t = z * z / 4.0
    small_i1 = z * _poly(
        (z / 3.75) ** 2,
        [0.00032411, 0.00301532, 0.02658733, 0.15084934, 0.51498869, 0.87890594, 0.5],
    )
    small = (
        xp.log(xp.maximum(z, _tiny(z)) / 2.0) * small_i1
        + (1.0 / xp.maximum(z, _tiny(z)))
        * _poly(
            t,
            [-0.00004686, -0.00110404, -0.01919402, -0.18156897, -0.67278579, 0.15443144, 1.0],
        )
    ) * xp.exp(z)
    u = 2.0 / z
    large = _poly(
        u,
        [-0.00068245, 0.00325614, -0.00780353, 0.01504268, -0.03655620, 0.23498619, 1.25331414],
    ) / xp.sqrt(z)
    return xp.where(z <= 2.0, small, large)


def bessel_k2e(z):
    """exp(z) * K2(z) via the recurrence K2 = K0 + (2/z) K1."""
    return bessel_k0e(z) + (2.0 / z) * bessel_k1e(z)


def maxwell_juttner_pdf(gamma, theta):
    """Normalized Maxwell-Juttner n(gamma) at dimensionless temperature theta
    (singleMaxwellJuttner, reference: Src/electron.c:538-560): K2(1/theta)
    exp(1/theta) for theta > 1e-2, the small-theta limit sqrt(pi theta / 2)
    below."""
    xp = xp_for(gamma, theta)
    norm = xp.where(
        theta > 1e-2,
        bessel_k2e(1.0 / theta),
        xp.sqrt(math.pi * theta / 2.0),
    )
    g2 = gamma * gamma
    return (
        gamma
        * xp.sqrt(xp.maximum(g2 - 1.0, 0.0))
        / (theta * norm)
        * xp.exp(-(gamma - 1.0) / theta)
    )
