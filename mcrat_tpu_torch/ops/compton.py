"""Batched polarized Compton / Klein-Nishina scattering (port of
``mcrat_tpu.ops.compton``).

:func:`kn_cross_section` is the float64 closed form that the hot
cross-section tables (``ops.hot_xsec``) and the XLA engine's acceptance use;
:func:`single_scatter` is the XLA engine's scatter (reference:
Src/mcrat_scattering.c:151-623) over an ``(N,)`` photon axis, drawing from a
threefry :class:`~mcrat_tpu_torch.ops.prng.Key` exactly as JAX's does.  The
fused-round kernel has its own collapsed form (``ops.fused_round``).  All
four-momenta are dimensionless (units of m_e c).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._xp import xp_for
from .fourvec import lorentz_boost, rotate_about_y_cs, rotate_about_z_cs
from .prng import Key, batched_rejection
from .stokes import (dot, fano_scatter_stokes, rotate_basis_vectors, stokes_rotation,
                     z_hat_like)


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


def sample_kn_angles_cs(key: Key, e0, q, u, stokes_on: bool, max_iters: int = 16):
    """Scattering angles from the polarized KN differential cross section,
    as (cos t, sin t, cos phi, sin phi) (``mcrat_tpu.ops.compton.
    sample_kn_angles_cs``; kleinNishinaScatter's angle stage, reference:
    Src/mcrat_scattering.c:532-585).  ``e0`` is the photon energy in the
    electron rest frame over m_e c^2, (q, u) the Stokes parameters in the
    scattering-aligned basis.

    theta: rejection of f(c) = (1 + e(1-c))^-2 (e(1-c) + 1/(1+e(1-c)) + c^2)
    under the envelope 2.  phi: a point uniform in the unit disk, (cos phi,
    sin phi) = (x, y)/r, accepted against the phi factor normalized at
    phi_max = |atan2(-u, q)|/2 (uniform when unpolarized), r^2 doubling as
    the acceptance variate."""
    shape = tuple(e0.shape)
    dtype = e0.dtype
    tiny = torch.finfo(dtype).tiny
    k_theta, k_phi = key.split()

    def propose_theta(k):
        k1, k2 = k.split()
        return (k1.uniform(shape, dtype, -1.0, 1.0), k2.uniform(shape, dtype) * 2.0)

    def accept_theta(c, y):
        m = 1.0 + e0 * (1.0 - c)
        return y < (e0 * (1.0 - c) + 1.0 / m + c * c) / (m * m)

    zeros = torch.zeros(shape, dtype=dtype, device=e0.device)
    cos_theta, _ = batched_rejection(k_theta, shape, propose_theta, accept_theta,
                                     init=(zeros, zeros), max_iters=max_iters)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))

    if stokes_on:
        # phi-dependent factor (reference: mcrat_scattering.c:541-584)
        mu = 1.0 + e0 * (1.0 - cos_theta)
        # integer powers as lax.integer_pow evaluates them: x * (x * x)
        f_theta = (1.0 / mu + 1.0 / (mu * (mu * mu))
                   - (sin_theta * sin_theta) / (mu * mu)) * sin_theta
        pol_amp = sin_theta * (sin_theta * sin_theta) / (mu * mu)
        phi_max = torch.abs(torch.atan2(-u, q)) / 2.0
        norm = f_theta + pol_amp * (q * torch.cos(2 * phi_max) - u * torch.sin(2 * phi_max))
        unpolarized = (q == 0.0) & (u == 0.0)
        safe_norm = torch.where(norm != 0, norm, 1.0)

    def propose_phi(k):
        xy = k.uniform(shape + (2,), dtype, -1.0, 1.0)
        return (xy[..., 0], xy[..., 1])

    def accept_phi(x, y):
        r2 = x * x + y * y
        in_disk = (r2 <= 1.0) & (r2 > tiny)
        if not stokes_on:
            return in_disk
        safe_r2 = torch.clamp(r2, min=tiny)
        c2 = (x * x - y * y) / safe_r2
        s2 = (2.0 * x * y) / safe_r2
        f = (f_theta + pol_amp * (q * c2 - u * s2)) / safe_norm
        return in_disk & (unpolarized | (r2 < f))

    x, y = batched_rejection(k_phi, shape, propose_phi, accept_phi,
                             init=(torch.ones_like(zeros), zeros), max_iters=max_iters)
    inv_r = 1.0 / torch.sqrt(torch.clamp(x * x + y * y, min=tiny))
    return cos_theta, sin_theta, x * inv_r, y * inv_r


def sample_kn_angles(key: Key, e0, q, u, stokes_on: bool, max_iters: int = 24):
    """(theta, phi) form of :func:`sample_kn_angles_cs`, in radians."""
    ct, st, cp, sp = sample_kn_angles_cs(key, e0, q, u, stokes_on, max_iters)
    return torch.arccos(ct), torch.remainder(torch.atan2(sp, cp), 2.0 * math.pi)


class ScatterResult(NamedTuple):
    ph_p: torch.Tensor  # (N, 4) comoving four-momentum after the (possible) scatter
    s: torch.Tensor  # (N, 4) Stokes vector
    scattered: torch.Tensor  # (N,) bool: the scatter happened


def single_scatter(key: Key, el_p, ph_p, s, stokes_on: bool = True) -> ScatterResult:
    """Batched photon-electron scattering in the fluid frame
    (``mcrat_tpu.ops.compton.single_scatter``; singleScatter, reference:
    Src/mcrat_scattering.c:151-485): boost into the electron rest frame,
    Stokes-rotate across the boost, align the photon with +x, accept the
    event with probability sigma_KN/sigma_T, sample (theta, phi), Compton-
    shift, undo the alignment, Fano-scatter the Stokes vector in the k0-k
    plane, boost back.  Rejected photons keep their inputs (a null
    collision).  sigma_KN is the port's float64 closed form rounded once to
    the working dtype (fault F6 repaired)."""
    k_accept, k_angles = key.split()
    dtype = ph_p.dtype
    tiny = torch.finfo(dtype).tiny

    el_v = el_p[..., 1:] / el_p[..., :1]
    # boost into the electron rest frame (reference: mcrat_scattering.c:217-218)
    ph_rest = lorentz_boost(el_v, ph_p, photon=True)
    s_work = stokes_rotation(el_v, ph_p[..., 1:], ph_rest[..., 1:], s) if stokes_on else s
    ph_orig_vec = ph_rest[..., 1:]
    e0 = ph_rest[..., 0]

    # alignment rotations (reference: mcrat_scattering.c:244-298) from the
    # components: phi0 about z, then phi1 about y put the photon on +x
    rho0 = torch.sqrt(ph_rest[..., 1] ** 2 + ph_rest[..., 2] ** 2)
    has_xy = rho0 > 0
    safe_rho0 = torch.clamp(rho0, min=tiny)
    c0 = torch.where(has_xy, ph_rest[..., 1] / safe_rho0, 1.0)
    s0 = torch.where(has_xy, ph_rest[..., 2] / safe_rho0, 0.0)
    inv_e0 = torch.where(e0 > 0, 1.0 / torch.clamp(e0, min=tiny), 0.0)
    c1 = torch.where(e0 > 0, rho0 * inv_e0, 1.0)
    s1 = ph_rest[..., 3] * inv_e0

    # KN acceptance (reference: mcrat_scattering.c:518-521)
    accept_u = k_accept.uniform(e0.shape, dtype)
    scattered = accept_u <= kn_cross_section(e0).to(dtype)

    ct, st, c_phi, s_phi = sample_kn_angles_cs(k_angles, e0, s_work[..., 1], s_work[..., 2],
                                               stokes_on=stokes_on)
    # Compton shift (reference: mcrat_scattering.c:322); phi measured
    # clockwise from z to y (:323-325)
    e1 = e0 / (1.0 + e0 * (1.0 - ct))
    scat_aligned = torch.stack([e1 * ct, e1 * st * s_phi, e1 * st * c_phi], dim=-1)
    # undo the rotation about y, then about z (reference: :360-386)
    scat_vec = rotate_about_z_cs(rotate_about_y_cs(scat_aligned, c1, s1), c0, s0)

    if stokes_on:
        z = z_hat_like(ph_orig_vec)
        # into the k0-k scattering plane (reference: :402-405), the Fano
        # matrix at the vectors' own angle (:408), back to z-hat (:438-447)
        s_work2 = rotate_basis_vectors(ph_orig_vec, z, scat_vec, ph_orig_vec, s_work)
        cos_sc = dot(ph_orig_vec, scat_vec) / torch.clamp(e0 * e1, min=tiny)
        s_work2 = fano_scatter_stokes(s_work2, e0, e1, torch.clamp(cos_sc, -1.0, 1.0))
        s_work2 = rotate_basis_vectors(scat_vec, ph_orig_vec, scat_vec, z, s_work2)
    else:
        s_work2 = s_work

    ph_rest_new = torch.cat([e1[..., None], scat_vec], dim=-1)
    # back to the fluid frame (reference: mcrat_scattering.c:461-465)
    ph_comv_new = lorentz_boost(-el_v, ph_rest_new, photon=True)
    if stokes_on:
        s_work2 = stokes_rotation(-el_v, ph_rest_new[..., 1:], ph_comv_new[..., 1:], s_work2)

    mask = scattered[..., None]
    return ScatterResult(
        ph_p=torch.where(mask, ph_comv_new, ph_p),
        s=torch.where(mask, s_work2, s) if stokes_on else s,
        scattered=scattered,
    )
