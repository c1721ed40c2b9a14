"""One frame window with hot cross sections and power-law electrons, in
plain PyTorch.

The reference of a 2-D cylindrical frame on a uniform rectilinear grid in
MCRaT's TABLE optical depth (TAU_CALCULATION TABLE) with nonthermal
electrons (NONTHERMAL_E_DIST POWERLAW; Src/mcrat.h:269-279, 340-388).  It
keeps the window, the lookups, the glue and the scatter of the DIRECT
reference (``frame.py``, ``rounds.py``) and writes anew what this physics
changes, after upstream:

- the tau rate (calculateOpticalDepth, Src/optical_depth.c:7-112): the
  thermal depth tau0 = n_e sigma_T sigma_hat(eps', theta) (1 - beta cos)
  at the photon's comoving energy after the round's boost, sigma_hat from
  the bilinear table (``hot.sigma_thermal``, not the program's Chebyshev
  rows); each subgroup's depth tau_i = n_nt f_i sigma_T sigma_i(eps')
  (1 - beta cos), sigma_i linear in log eps' (``hot.sigma_subgroups``),
  biased to tau_norm (tau0, or subgroup 1's depth where the cell has no
  thermal electrons; the thermal bias is 1,
  calculateNonthermalScatteringBias, :170-183); the rate is the biased
  total;
- the electron (generateSingleElectron, Src/electron.c:7-68): thermal
  where a uniform times the total falls within tau0, else the first
  subgroup whose cumulative biased depth holds it, its gamma drawn by the
  inverse CDF of the power law within the subgroup (``hot.power_law_gamma``);
  the thermal draw and the electron's direction are ``rounds.py``'s.

The cell table holds the DIRECT reference's ultra rows (v0, v1, the lab
electron density, the temperature) and two more: gamma and the comoving
nonthermal density (calculateNonthermalElectronDens, Src/electron.c:677-706,
an input here, as the hydro frame is).  Departures from upstream:

- the uniform of the population choice is drawn (upstream's
  generateSingleElectron overrides it with 0.6, Src/electron.c:21);
- a subgroup whose depth is 0 (no nonthermal electrons in the cell) adds
  nothing to the biased total (upstream divides by it);
- the tables' departures are ``hot.py``'s.

It imports nothing of the program.  ``dtype`` is the working precision.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import frame as fm
from . import hot
from . import rounds as rd
from .constants import KB_OVER_MEC2, THOM_X_SECT

# the DIRECT reference's helpers this window shares
cell_holds = fm.cell_holds
photons_from_arrays = fm.photons_from_arrays

CELL_FIELDS = fm.CELL_FIELDS + ("nonthermal_dens",)
ROW_GAMMA, ROW_NT = 4, 5  # the rows after the ultra table's four
# draws of a round after rounds.py's: the population, the power-law uniform
POP = rd.OFFSETS.per_round + 1
STRIDE = POP + 1


@dataclasses.dataclass
class Inputs(fm.Inputs):
    """``frame.Inputs`` with the nonthermal electrons: ``cells`` also holds
    ``nonthermal_dens``."""

    electrons: hot.PowerLaw = None


def inputs(spec: dict, host, edges, photons: dict) -> Inputs:
    """The Inputs of a configuration ``spec`` (its ``powerlaw_index``,
    ``gamma_min``, ``gamma_max``, ``n_gamma``) from its host frame."""
    if edges is None:
        raise ValueError("the TABLE reference runs uniform rectilinear grids only")
    return Inputs(cells={k: np.asarray(getattr(host, k)) for k in CELL_FIELDS},
                  domain=np.asarray(host.domain), edges=edges, photons=photons,
                  dt_max=spec["frame_window_s"], stokes=spec["stokes"],
                  max_rounds=spec["max_rounds_per_frame"],
                  electrons=hot.PowerLaw(spec["powerlaw_index"], spec["gamma_min"],
                                         spec["gamma_max"], spec["n_gamma"]))


class _Cell(rd._Cell):
    """``rounds._Cell`` of the ultra table, with the cell's temperature as
    theta, its gamma and its lab nonthermal density."""

    def __init__(self, table, cl, grid: rd.Grid):
        super().__init__("ultra", table, cl, grid)
        self.theta = self.temp * KB_OVER_MEC2
        self.n_nt = table[ROW_NT, cl] * table[ROW_GAMMA, cl]


def _depths(tables: hot.Tables, cell: _Cell, e, fluid):
    """(the biased total rate, tau0, the (n, n_gamma) biased subgroup
    rates) at comoving energy ``e``."""
    frac = torch.as_tensor(tables.fractions, dtype=e.dtype, device=e.device)
    tau0 = cell.n_e * THOM_X_SECT * hot.sigma_thermal(tables, e, cell.theta) * fluid
    tau_i = (cell.n_nt * THOM_X_SECT * fluid)[:, None] * frac * hot.sigma_subgroups(tables, e)
    norm = torch.where(tau0 > 0, tau0, tau_i[:, 0])
    biased = torch.where(tau_i > 0, norm[:, None], 0.0)
    return tau0 + biased.sum(dim=1), tau0, biased


def _electron(base, k0, tables: hot.Tables, electrons: hot.PowerLaw, cell: _Cell, total, tau0,
              biased, dtype):
    """(gamma, gamma beta) of the scattering electron: thermal, or the
    subgroup the biased cumulative depths choose."""
    g_th, gb_th = rd._thermal_gamma_beta(base, k0, cell.temp, dtype)
    x = rd.rng.uniform(base, k0 + POP, dtype) * total
    thermal = x <= tau0
    cum = tau0[:, None] + torch.cumsum(biased, dim=1)
    sub = torch.clamp((x[:, None] > cum).sum(dim=1), max=electrons.n_gamma - 1)
    lo, hi = (torch.as_tensor(b, dtype=dtype, device=total.device)[sub]
              for b in zip(*electrons.bounds()))
    g_nt = hot.power_law_gamma(rd.rng.uniform(base, k0 + POP + 1, dtype), lo, hi, electrons.p)
    gb_nt = torch.sqrt(torch.clamp(g_nt * g_nt - 1.0, min=0.0))
    return torch.where(thermal, g_th, g_nt), torch.where(thermal, gb_th, gb_nt), thermal


def _rounds(st, alive, is_pool, in_grid, cell: _Cell, base, tables, electrons, stokes_on,
            inner_rounds, dtype, tally=None):
    """``inner_rounds`` rounds over a flat set of lanes: ``rounds._rounds``
    with the TABLE rate and the population's electron.  ``tally`` (a dict)
    adds the scatterings off thermal and off nonthermal electrons."""
    (p0, p1, p2, p3, px, py, pz, q, u, v, t_rem, ns, c0, c1, c2, c3) = st
    z_hat = (0.0, 0.0, 1.0)
    stalled = torch.zeros_like(alive)
    promoted = torch.zeros_like(alive)
    for r in range(inner_rounds):
        k0 = r * STRIDE
        act = alive & (t_rem > 0) & ~stalled
        bx, by, bz = cell.fluid_beta(px, py)
        fl_norm = torch.sqrt(bx * bx + by * by + bz * bz)
        ph_norm = torch.sqrt(p1 * p1 + p2 * p2 + p3 * p3)
        cos_ang = (bx * p1 + by * p2 + bz * p3) / torch.clamp(fl_norm * ph_norm, min=rd.TINY)
        b0, b1, b2, b3 = rd._boost(bx, by, bz, p0, p1, p2, p3)
        upd = act & in_grid
        c0, c1, c2, c3 = (torch.where(upd, b, c) for b, c in ((b0, c0), (b1, c1), (b2, c2),
                                                               (b3, c3)))
        total, tau0, biased = _depths(tables, cell, c0, 1.0 - cell.beta_mag * cos_ang)

        u1 = rd.rng.uniform_pos(base, k0 + rd.OFFSETS.free, dtype)
        mfp = torch.where(in_grid & (total > 0), -torch.log(u1) / torch.clamp(total, min=rd.TINY),
                          rd.DEFAULT_MFP)
        dt_scatt = mfp * rd._INV_C
        will = act & in_grid & (dt_scatt < t_rem)
        dt = torch.where(act, torch.where(will, dt_scatt, t_rem), 0.0)
        step = torch.where(act & ~is_pool, rd.C_LIGHT * dt / torch.clamp(p0, min=rd.TINY), 0.0)
        px, py, pz = px + step * p1, py + step * p2, pz + step * p3
        t_rem = t_rem - dt

        flow = fl_norm > 0
        f_ref = (torch.where(flow, bx, 0.0), torch.where(flow, by, 0.0),
                 torch.where(flow, bz, 1.0))
        mf_ref = tuple(torch.where(flow, -x, z) for x, z in zip((bx, by, bz), (0.0, 0.0, 1.0)))
        if stokes_on:
            qc, uc = rd._rotate_basis((p1, p2, p3), z_hat, (p1, p2, p3), f_ref, q, u)
        else:
            qc, uc = q, u
        g_e, gb_e, thermal = _electron(base, k0, tables, electrons, cell, total, tau0, biased,
                                       dtype)
        g0, ex, ey, ez = rd._electron_from_gamma(base, k0, g_e, gb_e, c1, c2, c3, dtype)
        sc, o0, o1, o2, o3, q2, u2, v2 = rd._single_scatter(
            base, k0, g0, ex, ey, ez, c0, c1, c2, c3, qc, uc, v, f_ref, stokes_on, dtype)
        scattered = will & sc
        if tally is not None:
            tally["thermal"] = tally.get("thermal", 0) + int((scattered & thermal).sum())
            tally["nonthermal"] = tally.get("nonthermal", 0) + int((scattered & ~thermal).sum())
        l0, l1, l2, l3 = rd._boost(-bx, -by, -bz, o0, o1, o2, o3)
        if stokes_on:
            ov, lv = (o1, o2, o3), (l1, l2, l3)
            ql, ul = rd._rotate_basis(ov, (-ex / g0, -ey / g0, -ez / g0), ov, mf_ref, q2, u2)
            ql, ul = rd._rotate_basis(lv, mf_ref, lv, z_hat, ql, ul)
            q, u, v = (torch.where(scattered, a, b) for a, b in ((ql, q), (ul, u), (v2, v)))
        p0, p1, p2, p3 = (torch.where(scattered, a, b)
                          for a, b in ((l0, p0), (l1, p1), (l2, p2), (l3, p3)))
        c0, c1, c2, c3 = (torch.where(scattered, a, b)
                          for a, b in ((o0, c0), (o1, c1), (o2, c2), (o3, c3)))
        ns = ns + scattered.to(ns.dtype)
        promoted = promoted | (scattered & is_pool)
        in_cell = cell.contains(px, py, pz)
        stalled = stalled | (act & in_grid & ~in_cell & (t_rem > 0))
    planes = (p0, p1, p2, p3, px, py, pz, q, u, v, t_rem, ns, c0, c1, c2, c3)
    return planes, stalled, promoted


def transport_window(inp: Inputs, generator: torch.Generator, device, dtype=torch.float32,
                     tally=None) -> tuple:
    """The population after one frame window of ``dt_max``: (photons dict,
    t_rem), as ``frame.transport_window`` runs it (calls of ``inner_rounds``
    rounds on the photons with time left, a lookup before each), with this
    module's rounds and the hot tables ``hot.build`` makes on ``device``.
    ``tally`` (a dict) receives the scatterings by population."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tables = hot.build(inp.electrons, str(device))
    frame = fm.build_frame(inp, device, dtype)
    extra = np.stack([inp.cells["gamma"], inp.cells["nonthermal_dens"]])
    table = torch.cat([frame.table, torch.as_tensor(extra, dtype=dtype, device=device)])
    index = fm.build_uniform_index(inp.edges, device, dtype)
    grid = fm.grid_scalars(frame, index)
    ph = photons_from_arrays(inp.photons, device, dtype)
    al = fm.alive(ph)
    pool = ph["ptype"] == fm.POOL_TYPE
    promoted_any = torch.zeros_like(al)
    zero = torch.zeros((), dtype=dtype, device=device)
    state = fm._planes(ph, torch.where(al, torch.as_tensor(inp.dt_max, dtype=dtype,
                                                           device=device), zero))
    cell = ph["cell"].clone()
    rounds_done = 0
    while rounds_done < inp.max_rounds:
        lanes = torch.nonzero(al & (state[rd.SP_TREM] > 0)).flatten()
        if lanes.numel() == 0:
            break
        found, in_grid = fm.find_cell_direct(index, frame, state[rd.SP_X: rd.SP_Z + 1, lanes].T)
        cell[lanes] = found
        flags = fm.lane_flags(al[lanes], pool[lanes], in_grid)
        cl = torch.clamp(found.long(), 0, table.shape[1] - 1)
        base = rd.rng.lane_base(rd.rng.rng_seed_i32(fm.draw_seed(generator)), lanes, 16384)
        sub = state[:, lanes]
        planes, _, promoted = _rounds(
            tuple(sub[i] for i in range(rd.N_STATE)), (flags & rd.FLAG_ALIVE) != 0,
            (flags & rd.FLAG_POOL) != 0, (flags & rd.FLAG_INGRID) != 0,
            _Cell(table, cl, grid), base, tables, inp.electrons, inp.stokes, inp.inner_rounds,
            dtype, tally)
        state[:, lanes] = torch.stack(planes)
        pool[lanes] = pool[lanes] & ~promoted
        promoted_any[lanes] = promoted_any[lanes] | promoted
        rounds_done += inp.inner_rounds
    cell, _ = fm.find_cell_direct(index, frame, state[rd.SP_X: rd.SP_Z + 1].T)

    def unplane(lo, hi):
        return state[lo:hi].T.contiguous()

    ones = torch.ones((state.shape[1], 1), dtype=state.dtype, device=device)
    out = dict(ph, p=unplane(rd.SP_P0, rd.SP_P3 + 1), pos=unplane(rd.SP_X, rd.SP_Z + 1),
               s=torch.cat([ones, unplane(rd.SP_Q, rd.SP_V + 1)], dim=1),
               num_scatt=state[rd.SP_NS].clone(), comv_p=unplane(rd.SP_C0, rd.SP_C3 + 1),
               cell=cell.to(torch.int32),
               ptype=torch.where(promoted_any & (ph["ptype"] == fm.POOL_TYPE),
                                 fm.COMPTONIZED_TYPE, ph["ptype"]).to(torch.int32))
    return out, state[rd.SP_TREM].clone()
