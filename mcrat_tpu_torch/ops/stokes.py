"""Batched Stokes-vector transport (port of ``mcrat_tpu.ops.stokes``): the
uncollapsed chain of the XLA engine.

The polarization machinery of the reference (Src/mcrat_scattering.c:10-149):
the Stokes basis (findXY), the basis rotation angle (findPhi), the Mueller
rotation in closed form, and the rotation across a Lorentz boost
(stokesRotation) at every frame change.  The fused-round kernel collapses
the same chain (``ops.fused_round``); this module is the engine's per-op
form.  Stokes vectors are ``(..., 4)`` tensors (I, Q/I, U/I, V/I) with
I == 1; photon directions ``(..., 3)``.  Cross and dot products are spelled
out component by component, in the order XLA evaluates ``jnp.cross`` and
``jnp.sum``.
"""
from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the trailing axis (``jnp.cross``)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of a * b over the trailing axis of 3."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Unit vectors along the trailing axis, zero for zero vectors
    (``mcrat_tpu.ops.fourvec.normalize``)."""
    n2 = dot(v, v)[..., None]
    inv = torch.rsqrt(torch.clamp(n2, min=torch.finfo(v.dtype).tiny))
    return v * torch.where(n2 > 0, inv, 0.0)


def z_hat_like(v: torch.Tensor) -> torch.Tensor:
    """z-hat in the shape of the (..., 3) tensor ``v``, filled on its device
    (a copy from host memory would sync with the host)."""
    z = torch.zeros_like(v)
    z[..., 2] = 1.0
    return z


def find_xy(v_ph, ref):
    """Stokes-plane basis (x, y) of photon direction ``v_ph`` against ``ref``
    (findXY, reference: Src/mcrat_scattering.c:41-65): y = normalize(ref x
    v_ph), x = normalize(y x v_ph)."""
    y = normalize(cross(ref, v_ph))
    x = normalize(cross(y, v_ph))
    return x, y


def find_phi(x_old, y_old, x_new, y_new):
    """Rotation angle between two Stokes bases (findPhi, reference:
    Src/mcrat_scattering.c:67-101): sign from x_old . y_new, magnitude
    acos(y_old . y_new) with the dot clamped to [-1, 1]."""
    factor = torch.sign(dot(x_old, y_new))
    d_yy = torch.clamp(dot(y_old, y_new), -1.0, 1.0)
    return -factor * torch.arccos(d_yy)


def mueller_rotate(theta, s):
    """The Mueller rotation of Stokes vectors (mullerMatrixRotation,
    reference: Src/mcrat_scattering.c:10-39): I' = I, Q' = Q cos2t - U sin2t,
    U' = Q sin2t + U cos2t, V' = V."""
    return mueller_rotate_cs(torch.cos(2.0 * theta), torch.sin(2.0 * theta), s)


def mueller_rotate_cs(c2, s2, s):
    """Mueller rotation with (cos 2theta, sin 2theta) given directly."""
    q, u = s[..., 1], s[..., 2]
    return torch.stack([s[..., 0], c2 * q - s2 * u, s2 * q + c2 * u, s[..., 3]], dim=-1)


def _rotation_cs(d, f):
    """(cos 2theta, sin 2theta) of theta = -f acos(d); f == 0 (a degenerate
    basis) is the identity, as find_phi's -0 * acos(d)."""
    c2 = torch.where(f == 0, 1.0, 2.0 * d * d - 1.0)
    s2 = -f * 2.0 * d * torch.sqrt(torch.clamp(1.0 - d * d, min=0.0))
    return c2, s2


def rotate_basis_vectors(v_old, ref_old, v_new, ref_new, s):
    """Stokes rotation between the bases of (v_old, ref_old) and (v_new,
    ref_new) without building them: with A = ref_old x v_old and B = ref_new
    x v_new, d = (A . B) / (|A| |B|) and f = sign((A x v_old) . B).  A
    degenerate basis (A or B zero) gives d = 0, f = 0: the identity."""
    a = cross(ref_old, v_old)
    b = cross(ref_new, v_new)
    n2 = dot(a, a) * dot(b, b)
    d = torch.clamp(dot(a, b) * torch.rsqrt(torch.clamp(n2, min=torch.finfo(s.dtype).tiny)),
                    -1.0, 1.0)
    d = torch.where(n2 > 0, d, 0.0)
    f = torch.sign(dot(cross(a, v_old), b))
    return mueller_rotate_cs(*_rotation_cs(d, f), s)


def rotate_basis(x_old, y_old, x_new, y_new, s):
    """mueller_rotate(find_phi(...), s) without the arccos: cos 2theta = 2 d^2
    - 1, sin 2theta = -f 2 d sqrt(1 - d^2)."""
    f = torch.sign(dot(x_old, y_new))
    d = torch.clamp(dot(y_old, y_new), -1.0, 1.0)
    return mueller_rotate_cs(*_rotation_cs(d, f), s)


def stokes_rotation(boost, v_ph, v_ph_boosted, s):
    """Rotate Stokes vectors through a Lorentz boost (stokesRotation,
    reference: Src/mcrat_scattering.c:103-149): z-hat basis -> boost basis
    in the old frame, then boost basis -> z-hat basis in the new one.
    ``boost`` is the boost 3-velocity, ``v_ph``/``v_ph_boosted`` the photon
    3-momentum before and after it."""
    z = z_hat_like(v_ph)
    s = rotate_basis_vectors(v_ph, z, v_ph, boost, s)
    return rotate_basis_vectors(v_ph_boosted, boost, v_ph_boosted, z, s)


def fano_scatter_stokes(s, e0, e1, cos_theta):
    """Scatter Stokes vectors with the Fano/Compton matrix and renormalize to
    I = 1 (reference: Src/mcrat_scattering.c:411-433, Lundman's convention).
    ``e0``/``e1`` are the photon energies before/after in units of m_e c,
    ``cos_theta`` the scattering angle's cosine."""
    ct = cos_theta
    st2 = torch.clamp(1.0 - ct * ct, min=0.0)
    de = e0 - e1
    m00 = 1.0 + ct * ct + (1.0 - ct) * de
    m11 = 1.0 + ct * ct
    m22 = 2.0 * ct
    m33 = 2.0 * ct + ct * (1.0 - ct) * de
    i = m00 * s[..., 0] + st2 * s[..., 1]
    q = st2 * s[..., 0] + m11 * s[..., 1]
    u = m22 * s[..., 2]
    v = m33 * s[..., 3]
    q, u, v = fano_normalized(i, q, u, v)
    return torch.stack([torch.ones_like(i), q, u, v], dim=-1)


def fano_normalized(fi, fq, fu, fv):
    """(q, u, v) = (fq, fu, fv) / fi in float64 (times the float64
    reciprocal of ``fi``, floored at 1e-300), the degree of polarization
    held to 1, rounded once to the inputs' dtype: fault F13 repaired, in the
    kernel's operation order (``csrc/fused_round.cu``).  ``fi``, the
    scattered intensity, is > 0 in exact arithmetic, but in float32 it rounds
    to 0 for a fully polarized photon scattered near 90 degrees in its
    polarization plane, and a float32 division then gives a NaN Stokes
    vector (the JAX package divides so, and keeps it)."""
    dtype = fi.dtype
    inv_i = 1.0 / torch.clamp(fi.to(torch.float64), min=1e-300)
    q, u, v = (x.to(torch.float64) * inv_i for x in (fq, fu, fv))
    deg2 = q * q + u * u + v * v
    scale = torch.where(deg2 > 1.0, 1.0 / torch.sqrt(deg2), 1.0)
    return (q * scale).to(dtype), (u * scale).to(dtype), (v * scale).to(dtype)
