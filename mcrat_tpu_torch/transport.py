"""Batched photon transport (port of ``mcrat_tpu.transport``).

Every photon advances through its own exponential free-path sequence within
the frame's time window, concurrently with all others:

    while any photon has frame-time left:
        lookup cell -> tau-rate -> sample dt -> move -> attempt KN scatter

Two engines run the rounds, chosen once a frame by :func:`frame_engine` as
the JAX package chooses (``fused_transport_available``):

* the fused-round kernel (``ops.fused_round``): a hand-written CUDA kernel
  on the card, its plain PyTorch twin on CPU tensors; float32;
* the XLA engine, :func:`transport_rounds`: the round as PyTorch ops with
  the JAX package's threefry draws (``ops.prng``), float32 or float64, on
  any device -- every float64 run, and every run the caller keeps off the
  kernel (``fused=False``).

Photon state is a fixed-capacity structure of arrays (:class:`Photons`)
with masking in place of the reference's null-photon slot recycling
(Src/photons.c).  Four-momenta are dimensionless (units of m_e c); positions
are in cm.

Every (dims x geometry) frame -- 2-D and 2.5-D cartesian/cylindrical/
spherical, 3-D cartesian/spherical/polar -- runs on a
:class:`~mcrat_tpu_torch.grid.RectilinearIndex` (uniform or not) or on an
AMR cell list (:class:`~mcrat_tpu_torch.grid.BinnedIndex`), with DIRECT
(Thomson) or TABLE (hot cross-section, ``ops.hot_xsec``) optical depth,
thermal electrons and, in TABLE mode, nonthermal (broken) power-law
electrons, Stokes on or off; cyclo-synchrotron pool photons scatter in place
and are promoted, and the population surgery of the cyclo-synchrotron frame
boundary (grow, append, extract the scattered-CS subset) runs on the device
without a host sync.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import (
    Config, Dims, Geometry, NonthermalDist, PhotonType, Spectrum, TauCalculation,
)
from .constants import C_LIGHT, H_OVER_MEC2, K_B, M_P, ME_C2, PL_CONST, THOM_X_SECT

from . import geometry as geo
from . import telemetry
from .device import resolve_device
from .grid import (PCOL, BinnedIndex, HydroFrame, HydroFrameHost, RectilinearIndex,
                   find_cell_direct, find_cell_direct_flags, find_cell_rows,
                   find_cell_rows_flags, flags_word, fluid_beta_from_rows, gather_rows)
from .ops import compton, electrons
from .ops import fused_round as fr
from .ops import hot_xsec
from .ops.fourvec import lorentz_boost
from .ops.prng import MASK32, Key
from .ops.stokes import stokes_rotation

# Default mean free path for photons outside the grid [cm] (Src/mclib.c:620)
DEFAULT_MFP = 1e12
# n_gamma = xi T'^3 [cm^-3 K^-3] (reference: Src/mclib.c:20-28)
NUM_DENS_COEFF_BB = 20.29
NUM_DENS_COEFF_WIEN = 8.44
# smallest working buffer compaction shrinks to (capacities stay powers of 2)
MIN_COMPACT_CAPACITY = 1024


@dataclasses.dataclass
class Photons:
    """Photon population: (N,) / (N, k) tensors on one device.

    Mirrors struct photon (reference: Src/mcrat.h:142-171) as SoA.
    ``weight`` is normalized by ``PhotonsMeta.weight_norm``.
    """

    p: torch.Tensor  # (N, 4) lab four-momentum, units m_e c
    comv_p: torch.Tensor  # (N, 4) comoving four-momentum
    pos: torch.Tensor  # (N, 3) MCRaT Cartesian position [cm]
    s: torch.Tensor  # (N, 4) Stokes (I, Q, U, V), I == 1
    weight: torch.Tensor  # (N,) normalized weight; 0 => null slot
    num_scatt: torch.Tensor  # (N,)
    cell: torch.Tensor  # (N,) int32 containing cell; -1 = outside/unknown
    ptype: torch.Tensor  # (N,) int32 PhotonType

    @property
    def capacity(self) -> int:
        return self.p.shape[0]

    @property
    def device(self) -> torch.device:
        return self.p.device

    @property
    def alive(self) -> torch.Tensor:
        return (self.weight > 0) & (self.ptype != int(PhotonType.NULL))

    def replace(self, **kw) -> "Photons":
        return dataclasses.replace(self, **kw)

    def fields(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


class PhotonsMeta(NamedTuple):
    """Host-side bookkeeping for a photon population."""

    weight_norm: float  # physical weight = weight * weight_norm
    n_injected: int


def empty_photons(capacity: int, dtype=torch.float32, device=None) -> Photons:
    """An all-NULL population of ``capacity`` slots on ``device`` (default:
    the card)."""
    device = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Photons(
        p=z(capacity, 4), comv_p=z(capacity, 4), pos=z(capacity, 3), s=z(capacity, 4),
        weight=z(capacity), num_scatt=z(capacity),
        cell=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        ptype=torch.full((capacity,), int(PhotonType.NULL), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Injection (host side, numpy float64)
# ---------------------------------------------------------------------------


def _injection_shell_mask(host: HydroFrameHost, rmin, rmax, theta_min, theta_max):
    """Cells whose corner-spherical extent intersects the injection shell
    (photonInjection's cell selection, reference: Src/mclib.c:37-70)."""
    cfg = host.cfg
    if cfg.dims is Dims.THREE and host.jet_axis != "z":
        # off-z jet axis (RIKEN 3-D): wedge from the theta' cache at cell
        # centres (Src/mclib_riken.c:965-1014), corner-extended in r
        r_lo = host.r - host.dr0 / 2
        r_hi = host.r + host.dr0 / 2
        return (
            (rmin <= r_hi) & (r_lo <= rmax)
            & (host.theta >= theta_min) & (host.theta < theta_max)
        )
    if cfg.dims is Dims.THREE:
        a0, a1, a2 = np.abs(host.r0), np.abs(host.r1), np.abs(host.r2)
        r_in, t_in = geo.hydro_to_spherical(
            cfg, a0 - host.dr0 / 2, a1 - host.dr1 / 2, a2 - host.dr2 / 2)
        r_out, t_out = geo.hydro_to_spherical(
            cfg, a0 + host.dr0 / 2, a1 + host.dr1 / 2, a2 + host.dr2 / 2)
    else:
        r_in, t_in = geo.hydro_to_spherical(
            cfg, host.r0 - host.dr0 / 2, host.r1 - host.dr1 / 2, 0.0)
        r_out, t_out = geo.hydro_to_spherical(
            cfg, host.r0 + host.dr0 / 2, host.r1 + host.dr1 / 2, 0.0)
    r_in, t_in, r_out, t_out = map(np.asarray, (r_in, t_in, r_out, t_out))
    return (rmin <= r_out) & (r_in <= rmax) & (t_out >= theta_min) & (t_in <= theta_max)


def sample_bb_frequency(rng: np.random.Generator, temp: np.ndarray) -> np.ndarray:
    """Blackbody frequencies by the Bjorkman & Wood (2001) zeta-series
    inverse method (reference: Src/mclib.c:199-214)."""
    n = len(temp)
    u1 = rng.random(n)
    kmax = 128
    cum = np.cumsum(1.0 / np.arange(1, kmax + 1, dtype=np.float64) ** 4)
    m = np.searchsorted(cum, (np.pi**4 / 90.0) * u1, side="left") + 1
    u = np.maximum(rng.random((4, n)), np.finfo(np.float64).tiny)
    x = -np.log(u[0] * u[1] * u[2] * u[3]) / m
    return x * K_B * temp / PL_CONST


def sample_wien_frequency(rng: np.random.Generator, temp: np.ndarray) -> np.ndarray:
    """Wien-spectrum frequencies by rejection (reference: Src/mclib.c:177-190)."""
    n = len(temp)
    out = np.zeros(n)
    todo = np.ones(n, dtype=bool)
    while todo.any():
        t = temp[todo]
        fr_ = rng.random(len(t)) * 6.3e11 * t
        y = rng.random(len(t))
        f = (1.0 / 1.29e31) * (fr_ / t) ** 3 / np.expm1(PL_CONST * fr_ / (K_B * t))
        acc = y <= f
        idx = np.flatnonzero(todo)[acc]
        out[idx] = fr_[acc]
        todo[idx] = False
    return out


def inject_photons(
    host: HydroFrameHost,
    r_inj: float,
    ph_weight: float,
    min_photons: int,
    max_photons: int,
    spect: Spectrum,
    theta_min: float,
    theta_max: float,
    fps: float,
    rng: np.random.Generator,
) -> Tuple[dict, float]:
    """Inject thermal photons into the shell r_inj +/- c/(2 fps).

    Host-side numpy photonInjection (reference: Src/mclib.c:9-300):
    per-cell expected counts n_i = (4/3) dV Gamma xi T'^3 / w drawn Poisson,
    the weight auto-tuned x10 / x0.5 until min <= N <= max; per photon a
    comoving BB/Wien frequency, an isotropic comoving direction boosted to
    the lab, a uniform position inside the cell and Stokes (1, 0, 0, 0).
    With the same ``rng`` state it returns the same arrays as
    ``mcrat_tpu.transport.inject_photons``.

    Returns (dict of numpy photon arrays, adjusted_weight).
    """
    cfg = host.cfg
    xi = NUM_DENS_COEFF_WIEN if spect is Spectrum.WIEN else NUM_DENS_COEFF_BB
    rmin = r_inj - 0.5 * C_LIGHT / fps
    rmax = r_inj + 0.5 * C_LIGHT / fps
    sel = np.flatnonzero(_injection_shell_mask(host, rmin, rmax, theta_min, theta_max))
    if len(sel) == 0:
        raise ValueError(
            f"no hydro cells intersect injection shell r={r_inj:.3e} +/- "
            f"{0.5*C_LIGHT/fps:.3e}, theta in [{theta_min}, {theta_max}]")
    dv = host.volumes()[sel]
    mean_unw = (4.0 / 3.0) * dv * host.gamma[sel] * xi * host.temp[sel] ** 3

    w = ph_weight
    # coarse pre-scaling keeps the Poisson means finite (Src/mclib.c:121-131)
    total = float(mean_unw.sum())
    while total / w > 10.0 * max_photons:
        w *= 10.0
    while total / w < 0.1 * max(min_photons, 1):
        w *= 0.5
    for _ in range(200):
        counts = rng.poisson(mean_unw / w)
        ph_tot = int(counts.sum())
        if ph_tot > max_photons:
            w *= 10.0
        elif ph_tot < min_photons:
            w *= 0.5
        else:
            break
    else:
        raise RuntimeError("injection weight auto-tune did not converge")

    cell_idx = np.repeat(sel, counts)
    n = len(cell_idx)
    temp = host.temp[cell_idx]
    fr_ = sample_wien_frequency(rng, temp) if spect is Spectrum.WIEN else sample_bb_frequency(rng, temp)
    e_hat = fr_ * H_OVER_MEC2

    # isotropic comoving direction (reference: mclib.c:225-233)
    com_phi = rng.random(n) * 2.0 * np.pi
    com_cos_t = rng.random(n) * 2.0 - 1.0
    com_sin_t = np.sqrt(np.maximum(1.0 - com_cos_t**2, 0.0))
    p_comv = np.stack([
        e_hat,
        e_hat * com_sin_t * np.cos(com_phi),
        e_hat * com_sin_t * np.sin(com_phi),
        e_hat * com_cos_t,
    ], axis=-1)

    # fluid velocity in MCRaT Cartesian at the cell (az = position phi in 2-D)
    if cfg.dims is Dims.THREE:
        pos_phi = np.zeros(n)
        x2 = host.r2[cell_idx]
    else:
        pos_phi = rng.random(n) * 2.0 * np.pi
        x2 = pos_phi
    v2 = host.v2[cell_idx] if cfg.dims is not Dims.TWO else np.zeros(n)
    bx, by, bz = geo.hydro_vector_to_cartesian(
        cfg, host.v0[cell_idx], host.v1[cell_idx], v2,
        host.r0[cell_idx], host.r1[cell_idx], x2)
    beta = -np.stack([np.asarray(bx), np.asarray(by), np.asarray(bz)], axis=-1)
    # comoving -> lab boost (boost velocity = -v_fluid; mclib.c:245-250)
    p_lab = np.asarray(lorentz_boost(beta, p_comv))

    # uniform position inside the cell (reference: mclib.c:263-270)
    u0 = (rng.random(n) - 0.5) * host.dr0[cell_idx]
    u1 = (rng.random(n) - 0.5) * host.dr1[cell_idx]
    if cfg.dims is Dims.THREE:
        u2 = (rng.random(n) - 0.5) * host.dr2[cell_idx]
        px, py, pz = geo.hydro_to_mcrat(
            cfg, host.r0[cell_idx] + u0, host.r1[cell_idx] + u1, host.r2[cell_idx] + u2)
    else:
        px, py, pz = geo.hydro_to_mcrat(
            cfg, host.r0[cell_idx] + u0, host.r1[cell_idx] + u1, pos_phi)
    pos = np.stack([np.asarray(px), np.asarray(py), np.asarray(pz)], axis=-1)

    s = np.zeros((n, 4))
    s[:, 0] = 1.0
    return dict(
        p=p_lab, comv_p=p_comv, pos=pos, s=s, weight=np.full(n, w),
        num_scatt=np.zeros(n), cell=cell_idx.astype(np.int32),
        ptype=np.full(n, int(PhotonType.INJECTED), np.int32),
    ), w


def photons_from_arrays(arrays: dict, capacity: Optional[int] = None,
                        dtype=torch.float32, device=None, weight_norm=None):
    """Pack host photon arrays into a fixed-capacity Photons + meta, on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    n = len(arrays["weight"])
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} photons")
    if weight_norm is None:
        weight_norm = float(np.median(arrays["weight"])) or 1.0

    def fill(val, tail_shape, fillval, tdtype):
        val = np.asarray(val)
        out = np.full((cap,) + tail_shape, fillval, dtype=val.dtype)
        out[:n] = val
        return torch.as_tensor(out, dtype=tdtype, device=device)

    ph = Photons(
        p=fill(arrays["p"], (4,), 0, dtype),
        comv_p=fill(arrays["comv_p"], (4,), 0, dtype),
        pos=fill(arrays["pos"], (3,), 0, dtype),
        s=fill(arrays["s"], (4,), 0, dtype),
        weight=fill(np.asarray(arrays["weight"]) / weight_norm, (), 0, dtype),
        num_scatt=fill(arrays["num_scatt"], (), 0, dtype),
        cell=fill(arrays["cell"], (), -1, torch.int32),
        ptype=fill(arrays["ptype"], (), int(PhotonType.NULL), torch.int32),
    )
    return ph, PhotonsMeta(weight_norm=weight_norm, n_injected=n)


def frame_time(photons: Photons, dt_max) -> torch.Tensor:
    """Initial per-photon frame time window."""
    dt = torch.as_tensor(dt_max, dtype=photons.p.dtype, device=photons.device)
    return torch.where(photons.alive, dt, torch.zeros((), dtype=dt.dtype, device=dt.device))


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------


class FrameResult(NamedTuple):
    photons: Photons
    n_scatt: int  # scattering events this frame (weightless count)
    n_rounds: int  # transport rounds taken
    t_rem: torch.Tensor  # (N,) frame time left per photon
    rebin_pending: bool = False  # True: the scattered-CS count passed cs_limit
    n_cs: Optional[int] = None  # live scattered-CS count of the last chunk (cs_limit set)
    engine: str = "kernel"  # the engine that ran: "kernel" or "xla"


class ChunkResult(NamedTuple):
    photons: Photons
    t_rem: torch.Tensor  # (N,) frame time left per photon
    n_scatt: torch.Tensor  # integer scalar
    n_rounds: int
    all_done: torch.Tensor  # bool scalar: no active photons remain
    n_active: torch.Tensor  # int64 scalar: alive photons with time left
    n_cs: Optional[torch.Tensor] = None  # live scattered-CS count (a mesh step's)
    # lanes the carried lookups searched (int64 on the device; traced frames only)
    n_searched: Optional[torch.Tensor] = None
    # rows the kernel calls reached through the row map, each call's rows whose
    # logical place is not their physical one (int64 on the device; traced
    # frames only)
    n_remapped: Optional[torch.Tensor] = None


def _count_cs(photons: Photons) -> torch.Tensor:
    """Live scattered-CS photon count (the rebin trigger population)."""
    is_cs = (photons.ptype == int(PhotonType.COMPTONIZED)) | (
        photons.ptype == int(PhotonType.UNABSORBED_CS))
    return (photons.alive & is_cs).sum()


# the (dims, geometry) frames mcrat_tpu defines (mcrat_tpu/geometry.py)
FRAMES = {
    Dims.TWO: (Geometry.CARTESIAN, Geometry.CYLINDRICAL, Geometry.SPHERICAL),
    Dims.TWO_POINT_FIVE: (Geometry.CARTESIAN, Geometry.CYLINDRICAL, Geometry.SPHERICAL),
    Dims.THREE: (Geometry.CARTESIAN, Geometry.SPHERICAL, Geometry.POLAR),
}


def unsupported_reason(cfg: Config, frame: HydroFrame, index) -> Optional[str]:
    """Why no engine can run this frame and index (not a frame or index the
    JAX package defines), or None when they can."""
    if not isinstance(index, (RectilinearIndex, BinnedIndex)):
        return f"{type(index).__name__}: not a spatial index (RectilinearIndex, BinnedIndex)"
    if cfg.geometry not in FRAMES[cfg.dims]:
        return f"{cfg.dims.name} {cfg.geometry.name}: not a frame mcrat_tpu defines"
    if isinstance(index, RectilinearIndex) and index.three_d != (cfg.dims is Dims.THREE):
        return f"a {'3-D' if index.three_d else '2-D'} index on a {cfg.dims.name} frame"
    return None


def _missing_tables(cfg: Config, xsec_table) -> Optional[str]:
    """What a TABLE run lacks of the tables it reads (``table_ok`` of
    ``mcrat_tpu.transport.fused_transport_available``), or None.  DIRECT
    runs ignore the table."""
    if cfg.tau_calculation is not TauCalculation.TABLE:
        return None
    if xsec_table is None:
        return ("TABLE optical depth needs xsec_table= "
                "(mcrat_tpu_torch.ops.hot_xsec.load_or_build)")
    if cfg.nonthermal_e_dist is not NonthermalDist.OFF and (
            xsec_table.nonthermal is None or xsec_table.subgroup_frac is None):
        return ("nonthermal electrons need an xsec_table with the subgroup table and "
                "fractions (load_or_build of a nonthermal config)")
    return None


def check_xsec_table(cfg: Config, xsec_table) -> None:
    """Raise ValueError where a TABLE run lacks its tables.  (The JAX
    package's ``_tau_rate`` quietly uses sigma_hat = 1 without a table; the
    port does not.)"""
    missing = _missing_tables(cfg, xsec_table)
    if missing is not None:
        raise ValueError(missing)


def _tau_rate(cfg: Config, photons: Photons, rows: torch.Tensor, xsec_table=None):
    """Per-photon optical depth per unit length [1/cm] in the cells whose
    packed rows (W, N) are ``rows`` (``mcrat_tpu.transport._tau_rate``;
    calculateOpticalDepth, reference: Src/optical_depth.c:7-112):

        rate = (dens_lab / m_p) sigma_T sigma_hat (1 - beta cos_angle)

    with the angle between the fluid velocity and the photon's lab
    momentum; sigma_hat = 1 in DIRECT mode, the hot cross section in TABLE
    mode.  With nonthermal electrons (and a table) each Lorentz-factor
    subgroup i adds its biased depth bias_i tau_i, bias_i = tau_norm / tau_i
    (tau_norm = tau_0, or subgroup 1's tau in cells without thermal
    electrons; the thermal bias is 1, :170-183).  Returns (rate, fluid beta
    (N, 3), None or (tau0, tau_i, bias_i, total) for the population
    choice)."""
    fluid_beta = fluid_beta_from_rows(cfg, rows, photons.pos[:, 0], photons.pos[:, 1])
    gam = rows[PCOL["gamma"]]
    pv = photons.p[:, 1:]
    tiny = torch.finfo(pv.dtype).tiny
    fl_norm = torch.sqrt((fluid_beta * fluid_beta).sum(dim=-1))
    ph_norm = torch.sqrt((pv * pv).sum(dim=-1))
    cos_ang = (fluid_beta * pv).sum(dim=-1) / torch.clamp(fl_norm * ph_norm, min=tiny)
    beta = torch.sqrt(torch.clamp(1.0 - 1.0 / (gam * gam), min=0.0))
    n_e_lab = rows[PCOL["dens_lab"]] / M_P
    fluid_factor = 1.0 - beta * cos_ang
    sigma_hat = 1.0
    if cfg.tau_calculation is TauCalculation.TABLE and xsec_table is not None:
        sigma_hat = hot_xsec.interp_thermal(xsec_table, photons.comv_p[:, 0], rows[PCOL["temp"]])
    tau0 = n_e_lab * THOM_X_SECT * sigma_hat * fluid_factor
    if cfg.nonthermal_e_dist is NonthermalDist.OFF or xsec_table is None:
        return tau0, fluid_beta, None
    sigma_sub = hot_xsec.interp_nonthermal(xsec_table, photons.comv_p[:, 0])
    frac = torch.as_tensor(xsec_table.subgroup_frac, dtype=tau0.dtype, device=tau0.device)
    n_nt_lab = rows[PCOL["nonthermal_dens"]] * gam
    tau_i = n_nt_lab[:, None] * frac[None, :] * THOM_X_SECT * sigma_sub * fluid_factor[:, None]
    tau_norm = torch.where(tau0 > 0, tau0, tau_i[:, 0])
    bias_i = tau_norm[:, None] / torch.clamp(tau_i, min=torch.finfo(tau0.dtype).tiny)
    total = tau0 + (bias_i * tau_i).sum(dim=-1)
    return total, fluid_beta, (tau0, tau_i, bias_i, total)


def _electrons(cfg: Config, key: Key, temp, comv_p, tau_aux):
    """The scattering electron of every lane: thermal, or with nonthermal
    populations the one the biased cumulative depths choose
    (generateSingleElectron, reference: Src/electron.c:7-68, with a proper
    uniform draw where the reference left the override random_num = 0.6 at
    :21)."""
    el_p = electrons.sample_thermal_electron(key, temp, comv_p)
    if tau_aux is None:
        return el_p
    tau0, tau_i, bias_i, total = tau_aux
    dtype = comv_p.dtype
    k_pop, k_nt = key.fold_in(1).split()
    u = k_pop.uniform(tau0.shape, dtype)
    safe_total = torch.clamp(total, min=torch.finfo(dtype).tiny)
    cum_thermal = tau0 / safe_total
    cum = cum_thermal[:, None] + torch.cumsum(bias_i * tau_i, dim=-1) / safe_total[:, None]
    subgroup = 1 + (u[:, None] > cum).to(torch.int32).sum(dim=-1)
    subgroup = torch.clamp(subgroup, 1, cfg.n_gamma)
    el_nt = electrons.sample_nonthermal_electron(k_nt, subgroup, comv_p, cfg)
    return torch.where((cum_thermal >= u)[:, None], el_p, el_nt)


def transport_rounds(
    cfg: Config,
    photons: Photons,
    frame: HydroFrame,
    index,
    t_rem: torch.Tensor,
    key: Key,
    xsec_table=None,
    stokes_on: bool = True,
    max_rounds: int = 0,
) -> ChunkResult:
    """Advance the population by up to ``max_rounds`` rounds on the XLA
    engine (``mcrat_tpu.transport.transport_rounds``; the frame loop of
    Src/mcrat.c:761-846): per round, each active photon's cell
    (:func:`~mcrat_tpu_torch.grid.find_cell_rows`, the cached-cell pin then
    the index search: on every lane on the plain path, on the lanes that
    left their cell in the card's one launch; the same cells either way),
    its optical depth (:func:`_tau_rate`), an exponential free
    path, the move (pool photons stay), and for photons whose free path ends
    inside the frame window a polarized Klein-Nishina scatter off a drawn
    electron (``ops.compton.single_scatter``); rejected scatters are null
    collisions.  A scattered pool photon becomes COMPTONIZED.

    Float32 or float64 on any device.  ``key`` is a threefry
    :class:`~mcrat_tpu_torch.ops.prng.Key` (moved to the photons' device),
    split per round as JAX splits it, so with the same key the engine draws
    JAX's numbers lane for lane.
    The cell properties are read from the frame's packed rows, which equal
    the rows JAX's loop carries on every in-grid lane.  The loop test is one
    host sync a round (eager PyTorch has no device-side while loop); 0
    ``max_rounds`` runs up to ``cfg.max_rounds_per_frame``.  ``photons`` is
    not modified.
    """
    check_xsec_table(cfg, xsec_table)
    key = Key(key.data.to(photons.device))
    dtype = photons.p.dtype
    tiny = torch.finfo(dtype).tiny
    cap = photons.capacity
    round_cap = max_rounds if max_rounds > 0 else cfg.max_rounds_per_frame
    n_cell = frame.num_elements
    ph = photons
    t_rem = t_rem.to(dtype)
    n_scatt = torch.zeros((), dtype=torch.int64 if dtype == torch.float64 else torch.int32,
                          device=photons.device)
    rounds = 0
    while rounds < round_cap:
        active = ph.alive & (t_rem > 0)
        if not bool(active.any()):
            break
        key, k_mfp, k_el, k_sc = key.split(4)
        # CS pool photons scatter in place but never move (Src/mclib.c:1070)
        is_pool = ph.ptype == int(PhotonType.CS_POOL)

        # 1.+2. containing cell and its packed rows
        cell, in_grid = find_cell_rows(cfg, index, frame, ph.pos, ph.cell, all_lanes=True)
        rows = frame.packed[:, torch.clamp(cell, 0, n_cell - 1).to(torch.int64)]
        rate, fluid_beta, tau_aux = _tau_rate(cfg, ph, rows, xsec_table)
        comv_p = lorentz_boost(fluid_beta, ph.p, photon=True)
        ph = ph.replace(comv_p=torch.where((active & in_grid)[:, None], comv_p, ph.comv_p),
                        cell=torch.where(active, cell, ph.cell))

        # 3. exponential free path -> candidate time step
        u = torch.clamp(k_mfp.uniform((cap,), dtype), min=tiny)
        mfp = torch.where(in_grid & (rate > 0), -torch.log(u) / torch.clamp(rate, min=tiny),
                          DEFAULT_MFP)
        dt_scatt = mfp / C_LIGHT
        will_scatter = active & in_grid & (dt_scatt < t_rem)
        dt = torch.where(active, torch.where(will_scatter, dt_scatt, t_rem), 0.0)

        # 4. advance along the lab direction at c (reference: mclib.c:1054-1100)
        inv_p0 = 1.0 / torch.clamp(ph.p[:, 0], min=tiny)
        step = (ph.p[:, 1:] * inv_p0[:, None]) * (C_LIGHT * dt)[:, None]
        moves = active & ~is_pool
        ph = ph.replace(pos=torch.where(moves[:, None], ph.pos + step, ph.pos))
        t_rem = t_rem - dt

        # 5. the scatter of the candidates (a null collision on reject)
        s_comv = (stokes_rotation(fluid_beta, ph.p[:, 1:], ph.comv_p[:, 1:], ph.s)
                  if stokes_on else ph.s)
        el_p = _electrons(cfg, k_el, rows[PCOL["temp"]], ph.comv_p, tau_aux)
        res = compton.single_scatter(k_sc, el_p, ph.comv_p, s_comv, stokes_on=stokes_on)
        scattered = will_scatter & res.scattered
        new_lab = lorentz_boost(-fluid_beta, res.ph_p, photon=True)
        s_lab = (stokes_rotation(-fluid_beta, res.ph_p[:, 1:], new_lab[:, 1:], res.s)
                 if stokes_on else res.s)
        mask = scattered[:, None]
        # a scattered pool photon is promoted (reference: Src/mcrat.c:791-808)
        ptype = torch.where(scattered & is_pool, int(PhotonType.COMPTONIZED), ph.ptype)
        ph = ph.replace(
            p=torch.where(mask, new_lab, ph.p),
            comv_p=torch.where(mask, res.ph_p, ph.comv_p),
            s=torch.where(mask, s_lab, ph.s),
            num_scatt=ph.num_scatt + scattered.to(dtype),
            ptype=ptype.to(torch.int32),
        )
        n_scatt = n_scatt + scattered.sum().to(n_scatt.dtype)
        rounds += 1

    active = ph.alive & (t_rem > 0)
    return ChunkResult(photons=ph, t_rem=t_rem, n_scatt=n_scatt, n_rounds=rounds,
                       all_done=~active.any(), n_active=active.sum())


def fused_transport_available(cfg: Config, photons: Photons, frame: HydroFrame,
                              index, xsec_table=None) -> bool:
    """True when the CUDA fused-round kernel covers this run: CUDA float32
    photons, a frame and index :func:`unsupported_reason` takes, TABLE with
    its tables; no capacity floor (a compacted tail runs on the kernel)."""
    return (
        photons.device.type == "cuda"
        and photons.p.dtype == torch.float32
        and _missing_tables(cfg, xsec_table) is None
        and unsupported_reason(cfg, frame, index) is None
    )


class KernelSetup(NamedTuple):
    """What a frame's fused-round calls share (:func:`select_variant`): the
    ``variant``, its (W, Ncell) float32 cell ``table``, ``cheb_base`` (0 for
    DIRECT, else the row where the TABLE Chebyshev rows start), ``nt`` (the
    nonthermal constants, or None), ``aux`` (TABLE's tables for the per-lane
    aux planes of the carried AMR path, :func:`aux_planes`; else None) and
    the ``grid`` scalars (:func:`grid_scalars`)."""

    variant: str
    table: torch.Tensor
    cheb_base: int
    nt: Optional[fr.NtConstants]
    aux: Optional[hot_xsec.HotCrossSectionTable]
    grid: fr.GridScalars


def select_variant(cfg: Config, frame: HydroFrame, index, xsec_table=None) -> KernelSetup:
    """The frame's :class:`KernelSetup`, after :func:`check_xsec_table` and
    :func:`unsupported_reason` (NotImplementedError).  The variant is
    ``mcrat_tpu.transport.transport_rounds_fused``'s selection, without the
    TPU's index-bit size limits: ultra on uniform 2-D
    cartesian/cylindrical/spherical frames without a phi-hat velocity and
    on uniform 3-D cartesian frames; slim on the other 2-D
    cartesian/cylindrical frames without one; packed everywhere else, and
    always with nonthermal electrons (they read the packed gamma and
    nonthermal-density rows).

    TABLE mode appends the ``hot_xsec.CHEB_ROWS`` per-cell Chebyshev rows
    (``hot_xsec.thermal_cheb_cells``, computed here) under the variant's
    rows, so ``cheb_base`` is 4 (ultra 2-D), 5 (ultra 3-D), 8 (slim) or
    16/24 (packed); nonthermal electrons add the global subgroup-1 fit and
    the sampler constants (``fused_round.nonthermal_constants``).

    A :class:`~mcrat_tpu_torch.grid.BinnedIndex` (the carried AMR path)
    takes the packed variant of the geometry, and in TABLE mode per-lane
    aux planes, not Chebyshev rows (mcrat_tpu/transport.py:713-720).  The
    per-frame fits are the spans ``hot_xsec.cheb_cells`` (the rows) and
    ``hot_xsec.nt_constants`` (the subgroup-1 fit and the constants)."""
    check_xsec_table(cfg, xsec_table)
    reason = unsupported_reason(cfg, frame, index)
    if reason is not None:
        raise NotImplementedError(reason)
    geom, dims = cfg.geometry, cfg.dims
    nonthermal = cfg.nonthermal_e_dist is not NonthermalDist.OFF
    cyl = geom in (Geometry.CARTESIAN, Geometry.CYLINDRICAL)
    carried = isinstance(index, BinnedIndex)
    uniform = (False,) * 3 if carried else index.uniform
    three_d = dims is Dims.THREE
    name = table = None
    if frame.packed_slim is not None and not three_d and not nonthermal and not carried:
        uniform2 = uniform[0] and uniform[1]
        if uniform2 and (cyl or (geom is Geometry.SPHERICAL and dims is Dims.TWO)):
            name, table = ("ultra_cyl2" if cyl else "ultra_sph2"), frame.phys
        elif cyl:
            name, table = "slim_cyl2", frame.packed_slim
    if name is None and dims is Dims.THREE:
        if geom is Geometry.CARTESIAN and all(uniform) and not nonthermal and not carried:
            name, table = "ultra_cart3", frame.phys
        else:
            name = {Geometry.CARTESIAN: "packed_cart3", Geometry.SPHERICAL: "packed_sph3",
                    Geometry.POLAR: "packed_pol3"}[geom]
    elif name is None:
        name = f"packed_{'cyl' if cyl else 'sph'}{'25' if dims is Dims.TWO_POINT_FIVE else '2'}"
    if table is None:
        table = frame.packed
    grid = grid_scalars(frame, index)
    if cfg.tau_calculation is not TauCalculation.TABLE:
        return KernelSetup(name, table, 0, None, None, grid)
    if carried:
        nt = fr.nonthermal_constants(cfg) if nonthermal else None
        return KernelSetup(name, table, 0, nt, xsec_table, grid)
    with telemetry.span("hot_xsec.cheb_cells"):
        cheb = hot_xsec.thermal_cheb_cells(xsec_table, frame.temp)
        table = torch.cat([table, cheb.to(table.device)], dim=0).contiguous()
    nt = None
    if nonthermal:
        with telemetry.span("hot_xsec.nt_constants"):
            sub1 = hot_xsec._sub1_cheb_static(cfg, xsec_table.log_e, xsec_table.nonthermal[:, 0])
            nt = fr.nonthermal_constants(cfg, sub1)
    return KernelSetup(name, table, fr.VARIANTS[name].width, nt, None, grid)


def grid_scalars(frame: HydroFrame, index) -> fr.GridScalars:
    """The kernel's grid scalars as exact float32 values (one host fetch).
    The packed variants read the domain only: on a BinnedIndex the uniform
    cell geometry is left at lo = 0, d = 1, n = 1."""
    dom = frame.domain.to(torch.float32).reshape(-1)
    if isinstance(index, BinnedIndex):
        v = dom.tolist()
        return fr.GridScalars(*v[:4], 0.0, 1.0, 0.0, 1.0, 1, dom4=v[4], dom5=v[5])
    lo = index.lo.float()
    d = [(e[1] - e[0]).float() for e in (index.edges0, index.edges1, index.edges2)]
    v = torch.stack([*dom, lo[0], d[0], lo[1], d[1], lo[2], d[2]]).tolist()
    _, n1, n2 = index.shape
    return fr.GridScalars(*v[:4], v[6], v[7], v[8], v[9], n1, dom4=v[4], dom5=v[5],
                          lo2=v[10], d2=v[11], n2=n2 if index.three_d else 1)


def draw_seed(generator: torch.Generator) -> int:
    """One int32 seed from a (CPU) generator: the port's stand-in for
    ``jax.random.split`` / ``randint`` on a key."""
    return int(torch.randint(-(2**31), 2**31 - 1, (1,), generator=generator,
                             dtype=torch.int64).item())


def lane_planes(photons: Photons, t_rem: torch.Tensor, s_rows: int = 128):
    """Photons -> the kernel's lane layout: (16, Npad) float32 state planes
    (``fused_round.SP_*``), Npad a multiple of ``s_rows * 128`` in the JAX
    (R, 128) C order, plus (Npad,) ``alive`` and ``pool`` masks.  Pad lanes
    are dead zeros."""
    dev = photons.device
    cap = photons.capacity
    r_raw = -(-cap // fr.LANES)
    n_pad = -(-r_raw // s_rows) * s_rows * fr.LANES
    state = torch.zeros((fr.N_STATE, n_pad), dtype=torch.float32, device=dev)
    state[fr.SP_P0: fr.SP_P3 + 1, :cap] = photons.p.T
    state[fr.SP_X: fr.SP_Z + 1, :cap] = photons.pos.T
    state[fr.SP_Q: fr.SP_V + 1, :cap] = photons.s[:, 1:].T
    state[fr.SP_TREM, :cap] = t_rem
    state[fr.SP_NS, :cap] = photons.num_scatt
    state[fr.SP_C0: fr.SP_C3 + 1, :cap] = photons.comv_p.T
    alive = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    alive[:cap] = photons.alive
    pool = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    pool[:cap] = photons.ptype == int(PhotonType.CS_POOL)
    return state, alive, pool


def aux_planes(cfg: Config, xsec_table, frame: HydroFrame, cell: torch.Tensor,
               e_comv: torch.Tensor) -> torch.Tensor:
    """The kernel's per-lane aux planes (2, N) float32 of the carried AMR
    path in TABLE mode (``aux_planes`` of mcrat_tpu/transport.py:811-849):
    row 0 the biased total tau coefficient before the fluid factor
    (1 - beta cos), row 1 the probability that the scattering electron is
    thermal.  ``_tau_rate`` at the comoving energy ``e_comv`` (the state's
    c0) in the lane's cell (clipped to a valid index); the kernel stalls a
    lane after it scatters or leaves its cell, so the planes stay valid for
    the whole call.  tau0 = n_e sigma_T sigma_hat; with nonthermal
    electrons the total is tau0 + N_GAMMA tau_norm (each subgroup's biased
    tau equals tau_norm: tau0 in thermal cells, else subgroup 1's;
    Src/optical_depth.c:60-112)."""
    rows = gather_rows(frame, cell)
    tiny = torch.finfo(torch.float32).tiny  # as JAX's glue, in any dtype
    sig = hot_xsec.interp_thermal(xsec_table, e_comv, rows[PCOL["temp"]])
    tau0 = rows[PCOL["dens_lab"]] * (1.0 / M_P) * THOM_X_SECT * sig
    if cfg.nonthermal_e_dist is NonthermalDist.OFF:
        return torch.stack([tau0, torch.ones_like(tau0)])
    sig_sub = hot_xsec.interp_nonthermal(xsec_table, e_comv)
    frac = torch.as_tensor(xsec_table.subgroup_frac, dtype=e_comv.dtype, device=e_comv.device)
    n_nt_lab = rows[PCOL["nonthermal_dens"]] * rows[PCOL["gamma"]]
    tau_1 = n_nt_lab * frac[0] * THOM_X_SECT * sig_sub[:, 0]
    tau_norm = torch.where(tau0 > 0, tau0, tau_1)
    total = tau0 + cfg.n_gamma * tau_norm
    return torch.stack([total, tau0 / torch.clamp(total, min=tiny)])


# the kernel's per-lane FLAG_* bits of the alive, pool and in-grid masks
_FLAG_BITS = (fr.FLAG_ALIVE, fr.FLAG_POOL, fr.FLAG_INGRID)


def lane_flags(alive, pool, in_grid) -> torch.Tensor:
    """The kernel's per-lane FLAG_* bits."""
    return flags_word(alive, pool, in_grid, _FLAG_BITS)


def direct_lane_inputs(cfg: Config, index: RectilinearIndex, frame: HydroFrame, pos, alive,
                       pool):
    """One fused-round call's lane inputs on the direct branch, (cell, safe,
    :func:`lane_flags` word): ``grid.find_cell_direct_flags``."""
    return find_cell_direct_flags(cfg, index, frame, pos, alive, pool, _FLAG_BITS)


def carried_lane_inputs(cfg: Config, index: BinnedIndex, frame: HydroFrame, pos, cached, alive,
                        pool, searched=None):
    """One fused-round call's lane inputs on the carried branch, (cell,
    safe, :func:`lane_flags` word), behind the lanes' cached cells:
    ``grid.find_cell_rows_flags``; ``searched`` gains the lanes searched."""
    return find_cell_rows_flags(cfg, index, frame, pos, cached, alive, pool, _FLAG_BITS,
                                searched=searched)


_NO_FLOAT64_KERNEL = ("the fused-round kernel runs float32 photons only (as the JAX "
                      "package's); float64 runs take the XLA engine (fused=None or False)")


def transport_rounds_fused(
    cfg: Config,
    photons: Photons,
    frame: HydroFrame,
    index,
    t_rem: torch.Tensor,
    base_seed: int,
    setup: KernelSetup,
    stokes_on: bool = True,
    max_rounds: int = 0,
    inner_rounds: int = 4,
    s_rows: int = 128,
    rounds_fn=fr.fused_rounds,
) -> ChunkResult:
    """Advance the population by up to ``max_rounds`` rounds through the
    fused-round kernel (``mcrat_tpu.transport.transport_rounds_fused``).

    Between kernel calls the containing cells are re-resolved; the kernel
    stalls a lane that leaves its cell.  A scatter uses the pre-move cell's
    properties, photons outside the grid advance on the default mean free
    path, pool photons scatter in place and are promoted to COMPTONIZED.

    Two branches, as JAX's glue:

    * direct (:class:`~mcrat_tpu_torch.grid.RectilinearIndex`): every call
      looks every lane up (:func:`direct_lane_inputs`: ``find_cell_direct``,
      the clamp and the lane flags, on the card one launch); the active-first row
      partition is redone only when the active-row count dropped by >= 1/8;
    * carried (:class:`~mcrat_tpu_torch.grid.BinnedIndex`, AMR): each lane
      carries its cell, and before every call :func:`carried_lane_inputs`
      (``find_cell_rows``, the clamp and the lane flags, on the card one
      launch) re-resolves only the lanes that left it, as does a
      ``find_cell_rows`` once at the end; the partition runs
      before every call (the leading blocks active, ``block_act``), as
      JAX's carried loop, so the counter stream meets the same lane
      positions.  In TABLE mode the kernel reads per-lane aux planes
      (:func:`aux_planes`, from the tables in ``KernelSetup.aux``) and
      stalls a lane after it scatters as well.

    The lanes live in (16, Npad) float32 planes (``fused_round.SP_*``), Npad
    a multiple of ``s_rows * 128``, in the JAX (R, 128) C order, in the
    population's order throughout; the kernel updates them in place.  The
    active-first partition reorders a row map (logical 128-lane row ->
    physical row) that the kernel reads through, never the planes, the lane
    masks or the cells: a logical lane meets the counter stream and the
    ``block_act`` that JAX's partitioned lane meets.  ``photons`` is not
    modified.  The per-invocation seed is ``base_seed + rounds * 7919``
    (int32 wrap).  ``rounds_fn`` is the round implementation: the kernel
    wrapper, or ``fused_rounds_reference`` to run the plain twin on any
    device for comparisons.  ``setup`` is the
    frame's :class:`KernelSetup` (:func:`select_variant`, which checked the
    frame and index), built once a frame by the caller.
    """
    if photons.p.dtype != torch.float32:
        raise ValueError(_NO_FLOAT64_KERNEL)
    carried = isinstance(index, BinnedIndex)
    dev = photons.device
    cap = photons.capacity
    round_cap = max_rounds if max_rounds > 0 else cfg.max_rounds_per_frame
    lanes = fr.LANES
    block_lanes = s_rows * lanes
    with telemetry.span("transport.lane_planes"):
        state, alive, pool = lane_planes(photons, t_rem, s_rows)
        n_pad = state.shape[1]
        r_pad = n_pad // lanes
        n_blocks = r_pad // s_rows
        promoted_any = torch.zeros(n_pad, dtype=torch.bool, device=dev)
        row_iota = torch.arange(r_pad, dtype=torch.int32, device=dev)
        block_iota = torch.arange(n_blocks, device=dev)
        row_map = row_iota  # logical row -> physical row, across partitions
        ns0 = state[fr.SP_NS].to(torch.int64).sum()
        cell = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
        cell[:cap] = photons.cell
        # the carried lookups' searched lanes, for the counter grid.search_lanes,
        # and each call's row map, for transport.rows_remapped
        tracing = telemetry.tracing()
        searched = (torch.zeros((), dtype=torch.int64, device=dev)
                    if carried and tracing else None)
        maps = [] if tracing else None

    def pos(state):
        return state[fr.SP_X: fr.SP_Z + 1].T

    rounds, n_last = 0, r_pad
    while rounds < round_cap:
        act_row = (alive & (state[fr.SP_TREM] > 0)).view(r_pad, lanes).any(dim=1)
        # the loop test is one host sync per kernel call (eager PyTorch has
        # no device-side while loop); it also feeds the partition
        with telemetry.span("transport.loop_test"):
            n_act = int(act_row.sum())
        if n_act == 0:
            break
        act_row = act_row[row_map]  # in logical order
        if carried or n_act * 8 < n_last * 7:
            # stable active-first permutation of the logical rows; the direct
            # branch redoes it only when the active-row count dropped by
            # >= 1/8 and skips idle blocks in place through block_act between
            with telemetry.span("transport.partition"):
                perm = torch.argsort((~act_row).to(torch.int8), stable=True)
                row_map = row_map[perm]
                act_row = row_iota < n_act
            n_last = n_act
        if carried:
            block_act = (block_iota < -(-n_act // s_rows)).to(torch.int32)
            with telemetry.span("grid.lookup"):
                cell, safe, flags = carried_lane_inputs(cfg, index, frame, pos(state), cell,
                                                        alive, pool, searched)
        else:
            block_act = act_row.view(n_blocks, s_rows).any(dim=1).to(torch.int32)
            with telemetry.span("grid.lookup"):
                cell, safe, flags = direct_lane_inputs(cfg, index, frame, pos(state), alive,
                                                       pool)
        aux = None
        if setup.aux is not None:
            with telemetry.span("transport.aux_planes"):
                aux = aux_planes(cfg, setup.aux, frame, safe, state[fr.SP_C0]).contiguous()
            telemetry.count("transport.aux_lanes", n_pad)
        with telemetry.span("fused_round.call"):
            out = rounds_fn(
                state, safe, flags, setup.table, block_act,
                fr.rng_seed_i32(base_seed + rounds * 7919), setup.grid,
                stokes_on=stokes_on, inner_rounds=inner_rounds, block_lanes=block_lanes,
                variant=setup.variant, cheb_base=setup.cheb_base, nt=setup.nt, aux=aux,
                row_map=row_map,
            )
        telemetry.count("transport.kernel_calls")
        telemetry.count("transport.rows_active", n_act)
        telemetry.count("transport.rows_total", r_pad)
        if maps is not None:
            maps.append(row_map)
        promoted = (out & fr.OUT_PROMOTED) != 0
        pool = pool & ~promoted
        promoted_any = promoted_any | promoted
        rounds += inner_rounds

    # the last call's lane inputs and out-flags and the lane masks go before
    # the planes are copied back, the frame's peak of device memory
    safe = flags = aux = out = promoted = alive = pool = None
    # final cell sync for the photons that moved in the last kernel call
    with telemetry.span("grid.lookup"):
        if carried:
            cell, _ = find_cell_rows(cfg, index, frame, pos(state), cell, searched=searched)
        else:
            cell, _ = find_cell_direct(cfg, index, frame, pos(state))
    remapped = None
    if maps is not None:
        remapped = ((torch.stack(maps) != row_iota).sum() if maps else
                    torch.zeros((), dtype=torch.int64, device=dev))

    def unplane(lo, hi):
        return state[lo:hi, :cap].T.contiguous()

    with telemetry.span("transport.unplane"):
        ptype = torch.where(
            promoted_any[:cap] & (photons.ptype == int(PhotonType.CS_POOL)),
            int(PhotonType.COMPTONIZED), photons.ptype).to(torch.int32)
        stokes = torch.cat([torch.ones((cap, 1), dtype=torch.float32, device=dev),
                            unplane(fr.SP_Q, fr.SP_V + 1)], dim=1)
        ph = photons.replace(
            p=unplane(fr.SP_P0, fr.SP_P3 + 1), pos=unplane(fr.SP_X, fr.SP_Z + 1), s=stokes,
            num_scatt=state[fr.SP_NS, :cap].clone(),
            comv_p=unplane(fr.SP_C0, fr.SP_C3 + 1), cell=cell[:cap].contiguous(), ptype=ptype,
        )
        t_out = state[fr.SP_TREM, :cap].clone()
        n_scatt = state[fr.SP_NS].to(torch.int64).sum() - ns0
        active = ph.alive & (t_out > 0)
    return ChunkResult(
        photons=ph, t_rem=t_out, n_scatt=n_scatt, n_rounds=rounds,
        all_done=~active.any(), n_active=active.sum(), n_searched=searched,
        n_remapped=remapped,
    )


def _gather_photons(photons: Photons, idx: torch.Tensor) -> Photons:
    return Photons(**{k: v[idx] for k, v in photons.fields().items()})


def _scatter_photons(dst: Photons, slots: torch.Tensor, src: Photons) -> Photons:
    """Write ``src`` lanes into ``dst`` at ``slots``, IN PLACE (no second
    population buffer).  Pad lanes carry ``slots == dst.capacity`` and are
    dropped."""
    keep = slots < dst.capacity
    at = slots[keep].long()
    for k, v in dst.fields().items():
        v[at] = getattr(src, k)[keep]
    return dst


def _gather_active(work_ph: Photons, t_rem: torch.Tensor, slots: torch.Tensor, new_cap: int,
                   sentinel: int):
    """The active lanes of a working set gathered into a ``new_cap`` buffer
    (pad lanes dead): (photons, t_rem, slots; pads carry ``sentinel``)."""
    idx = torch.nonzero(work_ph.alive & (t_rem > 0)).flatten()[:new_cap]
    n = idx.numel()
    pad = torch.zeros(new_cap - n, dtype=idx.dtype, device=idx.device)
    safe = torch.cat([idx, pad])
    valid = torch.arange(new_cap, device=idx.device) < n
    sub = _gather_photons(work_ph, safe)
    sub.weight = torch.where(valid, sub.weight, 0.0)
    sub.ptype = torch.where(valid, sub.ptype, int(PhotonType.NULL)).to(torch.int32)
    sub_t = torch.where(valid, t_rem[safe], 0.0)
    sub_slots = torch.where(valid, slots[safe], sentinel).to(slots.dtype)
    return sub, sub_t, sub_slots


def _compact_step(result_ph: Photons, slots: Optional[torch.Tensor], work_ph: Photons,
                  t_rem: torch.Tensor, new_cap: int):
    """One compaction: write the working set back into ``result_ph`` (in
    place) and gather its active lanes into a ``new_cap`` buffer.

    ``slots`` maps working lanes to population slots (None: the working set
    is the population).  Returns ``(result_ph, sub_ph, sub_t, sub_slots)``;
    ``sub_slots`` maps working lanes to original slots, with pads set to
    ``result_ph.capacity`` so the final write-back drops them.  Pad lanes
    are dead (weight 0, ptype NULL) so they cannot transport twice.
    """
    if slots is None:
        slots = torch.arange(work_ph.capacity, dtype=torch.int64, device=work_ph.device)
    _scatter_photons(result_ph, slots, work_ph)
    return (result_ph, *_gather_active(work_ph, t_rem, slots, new_cap, result_ph.capacity))


def _write_back(result_ph: Photons, slots: torch.Tensor, work_ph: Photons,
                work_t: torch.Tensor):
    """The frame's last write-back of a compacted working set: (population,
    frame time left per slot, 0 where no working lane maps)."""
    result_ph = _scatter_photons(result_ph, slots, work_ph)
    result_t = torch.zeros(result_ph.capacity, dtype=work_t.dtype, device=work_t.device)
    keep = slots < result_ph.capacity
    result_t[slots[keep]] = work_t[keep]
    return result_ph, result_t


def device_scope(dev: torch.device):
    """``dev`` made current if it is a card (a kernel launches on the current device's stream)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class FrameEngine(NamedTuple):
    """A frame's engine (:func:`frame_engine`): ``fused`` (the kernel, else
    the XLA engine), ``key`` (the XLA engine's; None on the kernel) and each
    shard's (frame, index, :class:`KernelSetup` or None) in ``sites``."""

    cfg: Config
    xsec_table: Optional[hot_xsec.HotCrossSectionTable]
    fused: bool
    key: Optional[Key]
    sites: list

    def step(self, shard: int, photons: Photons, t_rem: torch.Tensor, draw, stokes_on=True,
             max_rounds=0, inner_rounds=4, s_rows=128, rounds_fn=fr.fused_rounds) -> ChunkResult:
        """One chunk of shard ``shard`` (0 on a plain frame): the kernel with
        base seed ``draw`` (:func:`transport_rounds_fused`) or the XLA
        engine with key ``draw`` (:func:`transport_rounds`)."""
        frame, index, setup = self.sites[shard]
        if self.fused:
            return transport_rounds_fused(
                self.cfg, photons, frame, index, t_rem, base_seed=draw, setup=setup,
                stokes_on=stokes_on, max_rounds=max_rounds, inner_rounds=inner_rounds,
                s_rows=s_rows, rounds_fn=rounds_fn)
        return transport_rounds(self.cfg, photons, frame, index, t_rem, draw,
                                xsec_table=self.xsec_table, stokes_on=stokes_on,
                                max_rounds=max_rounds)


def frame_engine(cfg: Config, photons: Photons, sites, xsec_table=None,
                 fused: Optional[bool] = None, generator: Optional[torch.Generator] = None,
                 key: Optional[Key] = None) -> FrameEngine:
    """The engine of a frame whose shards are ``sites`` (each a (device,
    frame, index); one on a plain frame), chosen and checked once a frame on
    ``photons`` (the first shard's) and the first site, as
    :func:`transport_frame` says.  The kernel gets one :class:`KernelSetup`
    a device (:func:`select_variant`, in the span
    ``transport.select_variant``); the XLA engine ``key`` or, without one,
    a key seeded by one draw of ``generator``."""
    dev0, frame, index = sites[0]
    check_xsec_table(cfg, xsec_table)
    reason = unsupported_reason(cfg, frame, index)
    if reason is not None:
        raise NotImplementedError(reason)
    if fused is None:
        fused = fused_transport_available(cfg, photons, frame, index, xsec_table)
    if fused and photons.p.dtype != torch.float32:
        raise ValueError("fused=True: " + _NO_FLOAT64_KERNEL)
    if generator is None and (fused or key is None):
        raise ValueError("a frame needs generator= (on the XLA engine generator= or key=)")
    setups = {}
    if fused:
        key = None
        with telemetry.span("transport.select_variant"):
            for dev, f, ix in sites:
                if dev not in setups:
                    with device_scope(dev):
                        setups[dev] = select_variant(cfg, f, ix, xsec_table)
    elif key is None:
        key = Key.from_seed(draw_seed(generator) & MASK32, device=dev0)
    return FrameEngine(cfg, xsec_table, fused, key,
                       [(f, ix, setups.get(dev)) for dev, f, ix in sites])


class Shards(NamedTuple):
    """The hooks through which ``parallel.mesh`` shards :func:`transport_frame`'s
    chunk loop (the JAX package's): ``sites`` for :func:`frame_engine`;
    ``step(engine, work_ph, work_t, sub)``, a chunk of every shard (``sub``
    the chunk's key split; ``n_rounds`` a tensor and ``n_cs`` a count may
    ride in the chunk's fetch); ``compact`` and ``finish`` for
    :func:`_compact_step` (``new_cap`` may grow) and :func:`_write_back`."""

    sites: list
    step: Callable
    compact: Callable
    finish: Callable


def transport_frame(
    cfg: Config,
    photons: Photons,
    frame: HydroFrame,
    index,
    dt_max,
    generator: Optional[torch.Generator] = None,
    stokes_on: bool = True,
    chunk_rounds: int = 0,
    fused: Optional[bool] = None,
    s_rows: int = 128,
    rounds_fn=fr.fused_rounds,
    xsec_table=None,
    t_rem0: Optional[torch.Tensor] = None,
    cs_limit: Optional[int] = None,
    key: Optional[Key] = None,
    shards: Optional[Shards] = None,
    min_compact_capacity: Optional[int] = None,
) -> FrameResult:
    """Advance the whole population through one hydro-frame time window.

    The engine (``FrameResult.engine``, :func:`frame_engine`), as the JAX
    package chooses it: ``fused=None`` takes the fused-round kernel
    (:func:`transport_rounds_fused`) exactly when
    :func:`fused_transport_available` holds (CUDA float32 photons, the
    tables a TABLE run needs) and the XLA engine (:func:`transport_rounds`)
    otherwise; ``fused=True`` takes the kernel on any device (the plain twin
    on CPU tensors) and raises ValueError for float64 photons, which no
    kernel runs; ``fused=False`` takes the XLA engine on any device and
    dtype.  NotImplementedError for a frame no engine runs
    (:func:`unsupported_reason`).  A kernel that fails to build or launch
    raises: no run moves to the other engine by itself.

    The engines run in bounded-round chunks when ``chunk_rounds`` > 0, with
    one batched host fetch per chunk.  Once fewer than a quarter of the lanes
    are still active, the active photons move into a power-of-two buffer
    (>= ``min_compact_capacity``, default MIN_COMPACT_CAPACITY) and
    transport continues there; results are written back into the population
    buffers IN PLACE (the caller's ``photons`` tensors are never written:
    the first chunk's output is the population buffer).

    The kernel draws each chunk's base seed from ``generator``; the XLA
    engine splits ``key`` (a threefry :class:`~mcrat_tpu_torch.ops.prng.Key`)
    once per chunk, ``key, sub = key.split()``, as JAX does, or, without a
    key, starts from one seeded by ``generator``.  ``rounds_fn`` is passed to
    :func:`transport_rounds_fused`.  TABLE mode needs ``xsec_table``
    (``ops.hot_xsec.load_or_build``; ValueError without); the kernel's
    setup, its per-cell Chebyshev rows included, is built once per frame.

    ``t_rem0`` resumes a frame left early (each photon's frame time, as a
    ``FrameResult.t_rem`` gives it).  ``cs_limit`` arms the mid-frame rebin
    trigger (the reference's every-1000-scatterings check, Src/mcrat.c:
    819-830): when the working set's live scattered-CS count, part of the
    chunk's fetch, passes it at a chunk boundary before the frame is done,
    the frame exits with ``rebin_pending`` and the whole population's
    ``t_rem``, so the driver can rebin and re-enter.

    ``shards`` (:class:`Shards`) shards every step over a device mesh
    (``photons`` then sharded, ``t_rem0`` required, ``frame`` and ``index``
    unused).  The frame is a :func:`telemetry.frame` scope: with tracing
    on, its steps are spans and its counts counters.
    """
    if min_compact_capacity is None:
        min_compact_capacity = MIN_COMPACT_CAPACITY
    first = photons if shards is None else photons.parts[0]  # the engine's checks and choice
    with telemetry.frame(telemetry.FRAME, first.device):
        if shards is None:
            def step(eng, work_ph, work_t, sub):
                return eng.step(0, work_ph, work_t, draw_seed(generator) if eng.fused else sub,
                                stokes_on=stokes_on, max_rounds=chunk_rounds, s_rows=s_rows,
                                rounds_fn=rounds_fn)

            shards = Shards([(photons.device, frame, index)], step, _compact_step, _write_back)
        eng = frame_engine(cfg, first, shards.sites, xsec_table, fused, generator, key)
        key = eng.key
        if t_rem0 is None:  # after the setup, whose TABLE fit is a frame's peak of memory
            t_rem0 = frame_time(photons, dt_max)
        n_scatt_total = 0
        rounds_total = 0
        work_ph, work_t = photons, t_rem0
        slots = None  # None => the working set is the full population
        result_ph = photons
        rebin_pending = False
        n_cs = None

        while True:
            sub = None
            if key is not None:
                key, sub = key.split()
            with telemetry.span("transport.step"):
                res = shards.step(eng, work_ph, work_t, sub)
            work_ph, work_t = res.photons, res.t_rem
            # ONE batched host fetch per chunk
            fetch = [res.n_scatt.to(torch.int64), res.all_done.to(torch.int64),
                     res.n_active.to(torch.int64)]
            rounds_on_device = isinstance(res.n_rounds, torch.Tensor)
            if rounds_on_device:
                fetch.append(res.n_rounds.to(torch.int64))
            if cs_limit is not None:
                fetch.append(_count_cs(work_ph) if res.n_cs is None else res.n_cs.to(torch.int64))
            if res.n_searched is not None:
                fetch.append(res.n_searched)
            if res.n_remapped is not None:
                fetch.append(res.n_remapped)
            with telemetry.span("transport.fetch"):
                n_scatt, all_done, n_active, *rest = torch.stack(fetch).tolist()
            if res.n_remapped is not None:
                telemetry.count("transport.rows_remapped", rest.pop())
            if res.n_searched is not None:
                telemetry.count("grid.search_lanes", rest.pop())
            n_scatt_total += n_scatt
            rounds_total += rest.pop(0) if rounds_on_device else res.n_rounds
            if cs_limit is not None:
                n_cs = rest[0]
                if n_cs > cs_limit and not all_done:
                    rebin_pending = True
                    break
            if all_done or chunk_rounds == 0 or rounds_total >= cfg.max_rounds_per_frame:
                break
            if work_ph.capacity > min_compact_capacity and n_active < work_ph.capacity // 4:
                if slots is None:
                    result_ph = work_ph
                new_cap = max(min_compact_capacity, 1 << int(np.ceil(np.log2(max(n_active, 1)))))
                with telemetry.span("transport.compact"):
                    result_ph, work_ph, work_t, slots = shards.compact(
                        result_ph, slots, work_ph, work_t, new_cap)

        if slots is None:
            result_ph, result_t = work_ph, work_t
        else:
            with telemetry.span("transport.write_back"):
                result_ph, result_t = shards.finish(result_ph, slots, work_ph, work_t)
        return FrameResult(photons=result_ph, n_scatt=n_scatt_total, n_rounds=rounds_total,
                           t_rem=result_t, rebin_pending=rebin_pending, n_cs=n_cs,
                           engine="kernel" if eng.fused else "xla")


# ---------------------------------------------------------------------------
# Population surgery on the device: grow, append, extract the CS subset,
# compact the live lanes (mcrat_tpu/transport.py:1375-1505).  Each returns
# fresh tensors, never writing the ones it was given, and none syncs with
# the host: free and CS lanes are ranked by a prefix sum, not ``nonzero``.
# ---------------------------------------------------------------------------


def _pow2(n: int, floor: int = 1024) -> int:
    return max(floor, 1 << int(np.ceil(np.log2(max(n, 1)))))


def _pad64k(n: int, floor: int = 1024) -> int:
    """``n`` rounded up to a multiple of 65,536 (a power of two below it):
    the persistence subset's size, at most ~15 % of dead lanes."""
    if n <= 65536:
        return _pow2(n, floor)
    return ((n + 65535) // 65536) * 65536


def _first_lanes(mask: torch.Tensor, n_out: int) -> torch.Tensor:
    """The first ``n_out`` lanes where ``mask`` holds, ascending, padded
    with -1 (``jnp.nonzero(mask, size=n_out, fill_value=-1)``), found by a
    prefix sum and a scatter, without a host sync."""
    cap = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    dst = torch.where(mask & (rank < n_out), rank, n_out)
    idx = torch.full((n_out + 1,), -1, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, dst, torch.arange(cap, dtype=torch.int64, device=mask.device))
    return idx[:n_out]


def _gather_first(photons: Photons, mask: torch.Tensor, n_out: int):
    """The first ``n_out`` lanes where ``mask`` holds, gathered into a new
    ``n_out``-lane population (pad lanes dead): (subset, the lanes gathered
    (pads at 0), valid)."""
    idx = _first_lanes(mask, n_out)
    valid = idx >= 0
    safe = torch.clamp(idx, min=0)
    sub = _gather_photons(photons, safe)
    sub.weight = torch.where(valid, sub.weight, 0.0)
    sub.ptype = torch.where(valid, sub.ptype, int(PhotonType.NULL)).to(torch.int32)
    return sub, safe, valid


def grow_photons(photons: Photons, new_cap: int, t_rem: Optional[torch.Tensor] = None):
    """The population copied into ``new_cap`` lanes, the new ones NULL:
    (photons, t_rem grown alongside with zeros, or None)."""
    grown = empty_photons(new_cap, photons.p.dtype, photons.device)
    for k, v in grown.fields().items():
        v[:photons.capacity] = getattr(photons, k)
    if t_rem is None:
        return grown, None
    t_new = torch.zeros(new_cap, dtype=t_rem.dtype, device=t_rem.device)
    t_new[:t_rem.shape[0]] = t_rem
    return grown, t_new


def append_photons_device(photons: Photons, new: Photons, t_rem=None, new_t=None):
    """``new``'s live lanes written into ``photons``' first free slots, in
    ascending order (``mcrat_tpu.transport.append_photons_device``):
    (photons, t_rem with ``new_t`` appended the same way, or None).  The
    caller guarantees the free slots (capacity - live count, known from
    ``frame_stats``); lanes past the free slots are dropped."""
    cap = photons.capacity
    free = _first_lanes(~photons.alive, new.capacity)
    slots = torch.where(new.alive & (free >= 0), free, cap)

    def put(dst, src):
        # one spare row takes the dropped lanes
        out = torch.cat([dst, dst[:1]])
        out[slots] = src.to(dst.dtype)
        return out[:cap]

    out = Photons(**{k: put(v, getattr(new, k)) for k, v in photons.fields().items()})
    return out, None if t_rem is None else put(t_rem, new_t)


def extract_cs_subset(photons: Photons, n_out: int, t_rem=None):
    """The device half of rebinning (``mcrat_tpu.transport.
    extract_cs_subset``): the first ``n_out`` live scattered-CS lanes
    gathered into an ``n_out``-lane population (pad lanes dead), and
    nulled in the population.  Only the gathered lanes are nulled: the
    caller sizes ``n_out`` from a count that can fall short of the
    population's CS lanes (the chunk fetch counts the compacted working
    set), and the lanes past ``n_out`` stay for the next trigger.  Returns
    (population, subset, subset t_rem: ``t_rem``'s lanes or zeros)."""
    is_cs = photons.alive & ((photons.ptype == int(PhotonType.COMPTONIZED))
                             | (photons.ptype == int(PhotonType.UNABSORBED_CS)))
    sub, safe, valid = _gather_first(photons, is_cs, n_out)
    sub_t = (torch.where(valid, t_rem[safe], 0.0) if t_rem is not None
             else torch.zeros(n_out, dtype=photons.weight.dtype, device=photons.device))
    taken = is_cs & (torch.cumsum(is_cs.to(torch.int64), 0) <= n_out)
    nulled = photons.replace(
        weight=torch.where(taken, 0.0, photons.weight),
        ptype=torch.where(taken, int(PhotonType.NULL), photons.ptype).to(torch.int32))
    return nulled, sub, sub_t


def compact_live(photons: Photons, n_out: int) -> Photons:
    """The live lanes, in slot order, gathered into a new ``n_out``-lane
    population on the same device (pad lanes dead); the persistence path
    fetches this instead of the whole population.  Every field is a fresh
    tensor, never a view of ``photons``, whose buffers the next frame
    writes in place.  No host sync: the first ``n_out`` live slots are
    found by a prefix sum and a scatter, not by ``nonzero``."""
    return _gather_first(photons, photons.alive, n_out)[0]


# ---------------------------------------------------------------------------
# Statistics (reference: Src/mclib.c:1358-1515)
# ---------------------------------------------------------------------------


def average_photon_energy(photons: Photons) -> torch.Tensor:
    """Weighted mean lab energy [erg] (averagePhotonEnergy, mclib.c:1358)."""
    w = torch.where(photons.alive, photons.weight, 0.0)
    e = (photons.p[:, 0] * w).sum() / torch.clamp(w.sum(), min=torch.finfo(w.dtype).tiny)
    return e * ME_C2


def scatt_stats(photons: Photons):
    """(max, min, mean) scatterings and mean radius over live photons
    (phScattStats, Src/mclib.c:1385-1462)."""
    alive = photons.alive
    ns = photons.num_scatt
    inf = torch.tensor(float("inf"), dtype=ns.dtype, device=ns.device)
    mx = torch.where(alive, ns, -inf).max()
    mn = torch.where(alive, ns, inf).min()
    cnt = torch.clamp(alive.sum(), min=1)
    mean = torch.where(alive, ns, 0.0).sum() / cnt
    r = torch.sqrt((photons.pos ** 2).sum(dim=-1))
    r_mean = torch.where(alive, r, 0.0).sum() / cnt
    return mx, mn, mean, r_mean


def ph_min_max(photons: Photons):
    """(r_min, r_max, theta_min, theta_max) over live photons (phMinMax,
    Src/mclib.c:1465-1515)."""
    alive = photons.alive
    r = torch.sqrt((photons.pos ** 2).sum(dim=-1))
    theta = torch.arccos(torch.clamp(
        photons.pos[:, 2] / torch.clamp(r, min=torch.finfo(r.dtype).tiny), -1.0, 1.0))
    inf = torch.tensor(float("inf"), dtype=r.dtype, device=r.device)
    return (
        torch.where(alive, r, inf).min(), torch.where(alive, r, -inf).max(),
        torch.where(alive, theta, inf).min(), torch.where(alive, theta, -inf).max(),
    )


def frame_stats(photons: Photons) -> torch.Tensor:
    """All per-frame statistics as ONE (11,) tensor, for one host
    fetch per frame:

        [0:4] scatt_stats  (max, min, mean num_scatt, mean r)
        [4:8] ph_min_max   (r_min, r_max, theta_min, theta_max)
        [8]   live CS_POOL photon count
        [9]   live photon count
        [10]  live scattered-CS count
    """
    alive = photons.alive
    dtype = photons.p.dtype
    n_pool = (alive & (photons.ptype == int(PhotonType.CS_POOL))).sum()
    return torch.stack([
        *(x.to(dtype) for x in scatt_stats(photons)),
        *ph_min_max(photons),
        n_pool.to(dtype), alive.sum().to(dtype), _count_cs(photons).to(dtype),
    ])
