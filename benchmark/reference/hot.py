"""Hot Compton cross sections and power-law electrons, in plain PyTorch.

What the reference of a TABLE frame with nonthermal electrons reads: the
thermal table of sigma_hat(eps', theta) / sigma_T (MCRaT's
calculateTotalThermalCrossSection, Src/hot_x_section.c:324-400) and the
nonthermal table of each Lorentz-factor subgroup
(calculateTotalNonThermalCrossSection, :432-459) on the grid of
Src/hot_x_section.h:1-10 (log10 eps' in [-12, 6] in 220 steps, log10 theta
in [-4, 4] in 80), their interpolation, the subgroups' shares of the
distribution (calculateElectronDistSubgroupDens, Src/electron.c:655-675) and
the power-law draw within a subgroup (samplePowerLaw, Src/electron.c:253-270).

It imports nothing of the program.  Departures from upstream:

- the tables are a float64 tensor-product Gauss-Legendre quadrature (96
  gamma x 64 mu nodes thermal, 128 x 64 a subgroup), where upstream
  integrates by GSL's plain Monte Carlo: the same quadrature as the
  program's build, so that the two tables agree to rounding and the
  comparison tests the transport, not two integrators;
- the Maxwell-Juttner norm K2(1/theta) comes from the Abramowitz & Stegun
  9.8.5-9.8.8 polynomial fits (|err| < 2e-7), for the same reason;
- a photon energy below the table (eps' < 1e-12, where sigma_hat is 1 to
  1e-11) takes the table's edge, and one above it or a temperature above
  it the same quadrature at that point, where upstream recomputes by Monte
  Carlo; below theta = 1e-4 sigma_hat is the cold Klein-Nishina value, as
  upstream's table build takes it (:336-340);
- the subgroup shares are a 256-node Gauss-Legendre quadrature of the
  normalized power law, where upstream uses QAGS.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

LOG_E_MIN, LOG_E_MAX, N_E = -12.0, 6.0, 220
LOG_T_MIN, LOG_T_MAX, N_T = -4.0, 4.0, 80
G_NODES_THERMAL, G_NODES_SUBGROUP, MU_NODES = 96, 128, 64
FLOOR = 1e-30  # sigma_hat never falls near it on the table; log10 of 0 guarded


@dataclasses.dataclass(frozen=True)
class PowerLaw:
    """n(gamma) = A gamma^-p on [gamma_min, gamma_max], cut into
    ``n_gamma`` subgroups equal in log gamma."""

    p: float
    gamma_min: float
    gamma_max: float
    n_gamma: int = 3

    def bounds(self) -> list:
        """(gamma_lo, gamma_hi) of each subgroup."""
        lo, hi = math.log10(self.gamma_min), math.log10(self.gamma_max)
        dg = (hi - lo) / self.n_gamma
        return [(10.0 ** (lo + i * dg), 10.0 ** (lo + (i + 1) * dg))
                for i in range(self.n_gamma)]

    def norm(self) -> float:
        q = 1.0 - self.p
        if abs(q) < 1e-10:
            return 1.0 / math.log(self.gamma_max / self.gamma_min)
        return q / (self.gamma_max ** q - self.gamma_min ** q)

    def pdf(self, g):
        val = self.norm() * g ** (-self.p)
        return torch.where((g >= self.gamma_min) & (g <= self.gamma_max), val, 0.0)


@dataclasses.dataclass
class Tables:
    """log10(sigma_hat / sigma_T) on the grid, float64 numpy."""

    log_e: np.ndarray  # (N_E + 1,)
    log_t: np.ndarray  # (N_T + 1,)
    thermal: np.ndarray  # (N_E + 1, N_T + 1)
    subgroup: np.ndarray  # (N_E + 1, n_gamma)
    fractions: np.ndarray  # (n_gamma,) share of the electrons in each subgroup


# ---------------------------------------------------------------------------
# the integrand
# ---------------------------------------------------------------------------


def kn(e):
    """sigma_KN / sigma_T in float64: the closed form above e = 1e-3, 1 - 2 e
    below (kleinNishinaCrossSection, Src/mcrat_scattering.c:597-623)."""
    e = e.to(torch.float64)
    s = torch.clamp(e, min=1e-10)
    full = 0.75 * (2.0 / (s * s) + (1.0 / (2.0 * s) - (1.0 + s) / (s * s * s)) * torch.log1p(2.0 * s)
                   + (1.0 + s) / ((1.0 + 2.0 * s) * (1.0 + 2.0 * s)))
    return torch.where(e >= 1e-3, full, 1.0 - 2.0 * e)


def _poly(x, coeffs):
    r = torch.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        r = r * x + c
    return r


def _k2e(z):
    """exp(z) K2(z) = exp(z) (K0(z) + (2 / z) K1(z)), Abramowitz & Stegun
    9.8.5-9.8.8."""
    tiny = torch.finfo(z.dtype).tiny
    t = z * z / 4.0
    lg = torch.log(torch.clamp(z, min=tiny) / 2.0)
    i0 = _poly((z / 3.75) ** 2, [0.0045813, 0.0360768, 0.2659732, 1.2067492, 3.0899424,
                                 3.5156229, 1.0])
    i1 = z * _poly((z / 3.75) ** 2, [0.00032411, 0.00301532, 0.02658733, 0.15084934,
                                     0.51498869, 0.87890594, 0.5])
    k0_small = (-lg * i0 + _poly(t, [0.00000740, 0.00010750, 0.00262698, 0.03488590,
                                     0.23069756, 0.42278420, -0.57721566])) * torch.exp(z)
    k1_small = (lg * i1 + (1.0 / torch.clamp(z, min=tiny))
                * _poly(t, [-0.00004686, -0.00110404, -0.01919402, -0.18156897, -0.67278579,
                            0.15443144, 1.0])) * torch.exp(z)
    u = 2.0 / z
    k0_large = _poly(u, [0.00053208, -0.00251540, 0.00587872, -0.01062446, 0.02189568,
                         -0.07832358, 1.25331414]) / torch.sqrt(z)
    k1_large = _poly(u, [-0.00068245, 0.00325614, -0.00780353, 0.01504268, -0.03655620,
                         0.23498619, 1.25331414]) / torch.sqrt(z)
    small = z <= 2.0
    return (torch.where(small, k0_small, k0_large)
            + (2.0 / z) * torch.where(small, k1_small, k1_large))


def maxwell_juttner(gamma, theta):
    """Normalized Maxwell-Juttner n(gamma) (Src/electron.c:538-560)."""
    norm = torch.where(theta > 1e-2, _k2e(1.0 / theta), torch.sqrt(math.pi * theta / 2.0))
    return (gamma * torch.sqrt(torch.clamp(gamma * gamma - 1.0, min=0.0)) / (theta * norm)
            * torch.exp(-(gamma - 1.0) / theta))


def _gauss_legendre(n, a, b):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (b - a) * x + 0.5 * (b + a), 0.5 * (b - a) * w


def _boosted(eps, mu, gamma):
    """sigma_KN(eps gamma (1 - mu beta)) (1 - mu beta) (Src/hot_x_section.c:370-400)."""
    beta = torch.sqrt(torch.clamp(gamma * gamma - 1.0, min=0.0)) / gamma
    doppler = 1.0 - mu * beta
    return kn(eps * gamma * doppler) * doppler


def _thermal_integral(eps, theta, device):
    """sigma_hat at photon energies ``eps`` (a float or an (N,) tensor) and
    temperatures ``theta`` ((T,) or (N,) float64 tensor): the integral over
    gamma in [1, 1 + 12 theta] and mu in [-1, 1].  Shape (T,) or (N,)."""
    gx, gw = (torch.as_tensor(a, dtype=torch.float64, device=device)
              for a in _gauss_legendre(G_NODES_THERMAL, 0.0, 1.0))
    mx, mw = (torch.as_tensor(a, dtype=torch.float64, device=device)
              for a in _gauss_legendre(MU_NODES, -1.0, 1.0))
    th = theta[:, None]
    gamma = 1.0 + 12.0 * th * gx[None, :]  # (T, G)
    weight = 12.0 * th * gw[None, :]
    e = eps[:, None, None] if torch.is_tensor(eps) else eps
    inner = (_boosted(e, mx[None, None, :], gamma[..., None]) * mw).sum(dim=-1)
    return 0.5 * (maxwell_juttner(gamma, th) * inner * weight).sum(dim=-1)


def _log10_table(cols):
    return torch.log10(torch.clamp(torch.stack(cols), min=FLOOR)).cpu().numpy()


@functools.lru_cache(maxsize=4)
def build(electrons: PowerLaw, device: str = "cpu") -> Tables:
    """The thermal and subgroup tables, float64 on ``device``, and the
    subgroup shares (cached by distribution and device)."""
    log_e = np.linspace(LOG_E_MIN, LOG_E_MAX, N_E + 1)
    log_t = np.linspace(LOG_T_MIN, LOG_T_MAX, N_T + 1)
    theta = torch.as_tensor(10.0 ** log_t, dtype=torch.float64, device=device)
    thermal = _log10_table([_thermal_integral(float(e), theta, device) for e in 10.0 ** log_e])
    mx, mw = (torch.as_tensor(a, dtype=torch.float64, device=device)
              for a in _gauss_legendre(MU_NODES, -1.0, 1.0))
    cols = []
    for g_lo, g_hi in electrons.bounds():
        gx, gw = (torch.as_tensor(a, dtype=torch.float64, device=device)
                  for a in _gauss_legendre(G_NODES_SUBGROUP, g_lo, g_hi))
        pdf = electrons.pdf(gx)
        cols.append(torch.stack([
            0.5 * (pdf * (_boosted(float(e), mx[None, :], gx[:, None]) * mw).sum(-1) * gw).sum()
            for e in 10.0 ** log_e]))
    subgroup = _log10_table(cols).T.copy()
    fractions = np.zeros(electrons.n_gamma)
    for i, (g_lo, g_hi) in enumerate(electrons.bounds()):
        gx, gw = (torch.as_tensor(a, dtype=torch.float64)
                  for a in _gauss_legendre(256, g_lo, g_hi))
        fractions[i] = float((electrons.pdf(gx) * gw).sum())
    return Tables(log_e, log_t, thermal, subgroup, fractions)


# ---------------------------------------------------------------------------
# interpolation and the draw
# ---------------------------------------------------------------------------


def _cell(grid: np.ndarray, x):
    """(i, t): x in [grid[i], grid[i + 1]] at fraction t, clamped to the
    grid; the cell found by binary search (in float32, so that any working
    precision searches alike), as GSL's interpolation accelerator finds
    it."""
    n = grid.shape[0]
    g = torch.as_tensor(grid, dtype=x.dtype, device=x.device)
    xc = torch.clamp(x, g[0], g[-1])
    i = torch.searchsorted(torch.as_tensor(grid, dtype=torch.float32, device=x.device),
                           xc.float().contiguous(), right=True) - 1
    i = torch.clamp(i, 0, n - 2)
    return i, (xc - g[i]) / (g[i + 1] - g[i])


def sigma_thermal(tables: Tables, e, theta):
    """sigma_hat / sigma_T of photons of comoving energy ``e`` (units of
    m_e c^2) among electrons at ``theta`` = kT / m_e c^2, in their dtype:
    the bilinear spline of log10 sigma_hat in (log10 eps', log10 theta)
    (interpolateThermalHotCrossSection, Src/hot_x_section.c:545-605),
    the cold Klein-Nishina value below the theta floor, the quadrature
    above the table."""
    dtype, dev = e.dtype, e.device
    le = torch.log10(torch.clamp(e, min=torch.finfo(dtype).tiny))
    lt = torch.log10(torch.clamp(theta, min=torch.finfo(dtype).tiny))
    z = torch.as_tensor(tables.thermal, dtype=dtype, device=dev)
    i, ti = _cell(tables.log_e, le)
    j, tj = _cell(tables.log_t, lt)
    val = ((1 - ti) * (1 - tj) * z[i, j] + ti * (1 - tj) * z[i + 1, j]
           + (1 - ti) * tj * z[i, j + 1] + ti * tj * z[i + 1, j + 1])
    sig = 10.0 ** val
    above = (le > tables.log_e[-1]) | (lt > tables.log_t[-1])
    if bool(above.any()):
        idx = torch.nonzero(above).flatten()
        th = torch.broadcast_to(theta, e.shape)[idx].to(torch.float64)
        sig = sig.clone()
        sig[idx] = _thermal_integral(e[idx].to(torch.float64), th, dev).to(dtype)
    return torch.where(theta < 10.0 ** LOG_T_MIN, kn(e).to(dtype), sig)


def sigma_subgroups(tables: Tables, e):
    """(N, n_gamma) sigma / sigma_T of each subgroup: linear in
    (log10 eps', log10 sigma), edge-clamped (Src/optical_depth.c:151-168)."""
    le = torch.log10(torch.clamp(e, min=torch.finfo(e.dtype).tiny))
    z = torch.as_tensor(tables.subgroup, dtype=e.dtype, device=e.device)
    i, t = _cell(tables.log_e, le)
    return 10.0 ** ((1 - t)[:, None] * z[i] + t[:, None] * z[i + 1])


def power_law_gamma(u, g_lo, g_hi, p: float):
    """Inverse-CDF gamma of n(gamma) ~ gamma^-p on [g_lo, g_hi] at the
    uniform ``u`` (samplePowerLaw, Src/electron.c:253-270)."""
    q = 1.0 - p
    if abs(q) < 1e-10:
        return g_lo * torch.pow(g_hi / g_lo, u)
    a, b = torch.pow(g_lo, q), torch.pow(g_hi, q)
    return torch.pow(a + u * (b - a), 1.0 / q)
