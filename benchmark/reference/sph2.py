"""One transport frame window of a 2-D spherical frame, in plain PyTorch.

The reference of a 2-D spherical frame (hydro coordinates (r, theta),
theta from the jet axis) on a rectilinear grid whose axes may be uniform or
not (the fireball's radii are log-spaced), in DIRECT (Thomson) optical
depth with thermal electrons.  It keeps the window's shape, the photons,
the glue and the whole scatter and Stokes chain of the cylindrical
reference (``frame.py``, ``rounds.py``, imported, not edited) and writes
anew what spherical coordinates change.  Frozen copies of the program's:

- the cell table: ``mcrat_tpu_torch/grid.py`` ``HydroFrameHost.packed``
  (:228-253), the packed rows sin1 / cos1 holding sin and cos of the cell's
  theta (built by ``frame.build_frame`` of a cell list, whose rows are the
  same);
- the lookup: ``geometry.mcrat_to_hydro``'s 2-D spherical branch
  (``mcrat_tpu_torch/geometry.py:28-60``: r = |x|, theta = arccos of
  z / r clipped to [-1, 1]), ``grid._hydro_inside`` (``grid.py:578-585``,
  the strict domain test), ``RectilinearIndex.axis_index`` / ``find``
  (:321-346: a uniform axis by floor((x - lo) inv_d), any other by
  ``searchsorted(edges, x, right=True) - 1``, each clamped),
  ``build_rectilinear_index`` and ``_axis_uniform`` (:370-395: the index in
  float32, its edges compared in the promotion of the lanes' dtype and
  float32, as ``RectilinearIndex.lookup_tables`` gives them to the
  kernel), ``find_cell_direct_reference`` (:717-722);
- the round's spherical terms: ``mcrat_tpu_torch/ops/fused_round.py``
  ``_Cell`` (:619-766) for ``packed_sph2``: the fluid velocity
  (v_r sin theta_c + v_theta cos theta_c in the plane, v_r cos theta_c -
  v_theta sin theta_c along z, theta_c the cell's) and the post-move
  membership (r within the cell's radial extent; theta in cosine space,
  cos(theta - theta_c) >= cos(dtheta / 2); the domain's theta bounds as
  cosines; the strict radial domain);
- the glue: ``transport.grid_scalars`` (:678-691, the domain as float32
  values; a packed variant reads nothing else).

Departures from the program (each also the cylindrical reference's): the
window is calls of ``inner_rounds`` rounds on the photons with time left,
each looked up before its call, with no lanes, partition, chunks or
compaction of the program's, so the two agree in distribution, not photon
for photon; the Fano normalization divides in float64 (``rounds.py``).
Departure from upstream: upstream computes theta in double precision
(mcratCoordinateToHydroCoordinate, Src/geometry.c:15-64), where the
program, and so this reference, computes it in float32: within ~6e-4 rad
of the jet axis z / r rounds to 1 and theta to 0, the strict domain test
leaves the photon out of the grid and it streams on without scattering, on
both sides alike (``cell_holds`` accepts -1 there).

It imports nothing of the program.  ``dtype`` is the working precision.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import frame as fm
from . import rounds as rd

# the cylindrical reference's helpers this window shares
photons_from_arrays = fm.photons_from_arrays
# float32 steps below 1 that a lookup's cos(theta) = z / r may round away
# near the jet axis: theta there reads 0 (arccos(1)) and the strict domain
# test leaves the photon out
AXIS_ULPS = 4


def inputs(spec: dict, host, edges, photons: dict) -> fm.Inputs:
    """The Inputs of a configuration ``spec`` from its host frame and its
    (r, theta) edges."""
    if edges is None:
        raise ValueError("the spherical reference runs rectilinear (r, theta) grids only")
    return fm.inputs(spec, host, edges, photons)


# ---------------------------------------------------------------------------
# the cell table and the lookup
# ---------------------------------------------------------------------------


def build_frame(inp: fm.Inputs, device, dtype) -> fm.Frame:
    """The frame's columns and its packed cell table (``rounds.PCOL``)."""
    return fm.build_frame(dataclasses.replace(inp, edges=None), device, dtype)


def _axis_uniform(edges: np.ndarray) -> bool:
    d = np.diff(edges)
    return bool(d.size > 0 and np.allclose(d, d[0], rtol=1e-5, atol=0.0))


@dataclasses.dataclass
class Index:
    """Cell (i, j) of a 2-D rectilinear grid, cell = i * n1 + j; a uniform
    axis by arithmetic, any other by ``searchsorted``."""

    edges0: torch.Tensor
    edges1: torch.Tensor
    lo: torch.Tensor
    inv_d: torch.Tensor
    uniform: tuple

    def axis_index(self, axis: int, x):
        edges = (self.edges0, self.edges1)[axis]
        n = edges.shape[0] - 1
        if self.uniform[axis]:
            i = torch.floor((x - self.lo[axis]) * self.inv_d[axis]).to(torch.int32)
        else:
            v = x.to(torch.promote_types(x.dtype, edges.dtype)).contiguous()
            i = torch.searchsorted(edges, v, right=True).to(torch.int32) - 1
        return torch.clamp(i, 0, n - 1)

    def find(self, r0, r1):
        n1 = self.edges1.shape[0] - 1
        i = self.axis_index(0, r0)
        j = self.axis_index(1, r1)
        inside = ((r0 >= self.edges0[0]) & (r0 <= self.edges0[-1])
                  & (r1 >= self.edges1[0]) & (r1 <= self.edges1[-1]))
        return torch.where(inside, i * n1 + j, -1)


def build_index(edges, device, dtype=torch.float32) -> Index:
    """The index over (r, theta) edges (numpy float64), held in ``dtype``
    (the program's float32) whatever the lanes' precision."""
    e0, e1 = (np.asarray(e, dtype=np.float64) for e in edges)
    lo = np.array([e0[0], e1[0], 0.0])
    d = np.array([(e[-1] - e[0]) / max(e.size - 1, 1) for e in (e0, e1, np.array([0.0, 1.0]))])
    inv_d = 1.0 / np.where(d > 0, d, 1.0)

    def put(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return Index(edges0=put(e0), edges1=put(e1), lo=put(lo), inv_d=put(inv_d),
                 uniform=(_axis_uniform(e0), _axis_uniform(e1)))


def hydro_inside(frame: fm.Frame, pos):
    """Spherical (r, theta) of (N, 3) positions and the strict domain test."""
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    r0 = torch.sqrt(x * x + y * y + z * z)
    r1 = torch.arccos(torch.clamp(z / r0, -1.0, 1.0))
    dom = frame.domain
    inside = (r0 > dom[0, 0]) & (r0 < dom[0, 1]) & (r1 > dom[1, 0]) & (r1 < dom[1, 1])
    return r0, r1, inside


def find_cell(index: Index, frame: fm.Frame, pos):
    """(cell int32, -1 outside the domain; in_grid bool)."""
    r0, r1, inside = hydro_inside(frame, pos)
    cell = torch.where(inside, index.find(r0, r1), -1).to(torch.int32)
    return cell, inside & (cell >= 0)


def grid_scalars(frame: fm.Frame) -> rd.Grid:
    """The domain as float32 values (a packed variant reads nothing else)."""
    return rd.Grid(*frame.domain.to(torch.float32).reshape(-1).tolist()[:4])


# ---------------------------------------------------------------------------
# the round's spherical terms
# ---------------------------------------------------------------------------


class _Cell(rd._Cell):
    """``rounds._Cell`` of the packed table, with the spherical fluid basis
    and membership: the cell's sin and cos of theta, cos(dtheta / 2), and the
    domain's theta bounds as cosines."""

    def __init__(self, table, cl, grid: rd.Grid):
        super().__init__("packed", table, cl, grid)
        self.s1 = table[rd.PCOL["sin1"], cl]
        self.c1 = table[rd.PCOL["cos1"], cl]
        self.cos_half1 = torch.cos(0.5 * table[rd.PCOL["dr1"], cl])

        def cos_of(v):
            return torch.cos(torch.tensor(v, dtype=table.dtype, device=table.device))

        self.cos_dom2, self.cos_dom3 = cos_of(grid.dom2), cos_of(grid.dom3)

    def fluid_beta(self, px, py):
        """Fluid 3-velocity in MCRaT Cartesian at the photon position."""
        v0, v1 = self.v
        c2, s2 = rd._phi_components(px, py)
        vr = v0 * self.s1 + v1 * self.c1
        bz = v0 * self.c1 - v1 * self.s1
        return vr * c2, vr * s2, bz

    def contains(self, px, py, pz):
        """Post-move membership: the lane's cell and the strict domain,
        theta in cosine space."""
        g = self.grid
        rho = torch.sqrt(px * px + py * py)
        r = torch.sqrt(rho * rho + pz * pz)
        inv_r = 1.0 / torch.clamp(r, min=rd.TINY)
        cos_th = torch.clamp(pz * inv_r, -1.0, 1.0)
        sin_th = rho * inv_r
        in_theta = cos_th * self.c1 + sin_th * self.s1 >= self.cos_half1
        in_theta_dom = (cos_th < self.cos_dom2) & (cos_th > self.cos_dom3)
        in_r = 2.0 * torch.abs(r - self.centre[0]) - self.size[0] <= 0
        return in_r & in_theta & in_theta_dom & (r > g.dom0) & (r < g.dom1)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


def transport_window(inp: fm.Inputs, generator: torch.Generator, device,
                     dtype=torch.float32) -> tuple:
    """The population after one frame window of ``dt_max``: (photons dict,
    t_rem), as ``frame.transport_window`` runs it (calls of ``inner_rounds``
    rounds on the photons with time left, each photon drawing the counter
    stream of (the call's seed, its index), each call's seed drawn from
    ``generator``, a lookup before each call), with this module's frame,
    lookup and cell terms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frame = build_frame(inp, device, dtype)
    index = build_index(inp.edges, device)
    grid = grid_scalars(frame)
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
        found, in_grid = find_cell(index, frame, state[rd.SP_X: rd.SP_Z + 1, lanes].T)
        cell[lanes] = found
        flags = fm.lane_flags(al[lanes], pool[lanes], in_grid)
        cl = torch.clamp(found.long(), 0, frame.table.shape[1] - 1)
        base = rd.rng.lane_base(rd.rng.rng_seed_i32(fm.draw_seed(generator)), lanes, 16384)
        sub = state[:, lanes]
        planes, _, promoted = rd._rounds(
            tuple(sub[i] for i in range(rd.N_STATE)), (flags & rd.FLAG_ALIVE) != 0,
            (flags & rd.FLAG_POOL) != 0, (flags & rd.FLAG_INGRID) != 0,
            _Cell(frame.table, cl, grid), base, inp.stokes, inp.inner_rounds, dtype)
        state[:, lanes] = torch.stack(planes)
        del sub, planes  # the call's copies go before the next call's are made
        pool[lanes] = pool[lanes] & ~promoted
        promoted_any[lanes] = promoted_any[lanes] | promoted
        rounds_done += inp.inner_rounds
    cell, _ = find_cell(index, frame, state[rd.SP_X: rd.SP_Z + 1].T)

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


def cell_holds(inp: fm.Inputs, pos, cell, tol: float = 1e-2):
    """Which photons' cell is theirs, in float64: a cell >= 0 holds the
    (N, 3) position to ``tol`` of the cell's size in r and in theta; -1 only
    where no cell holds it by more than ``tol`` of its size: outside the
    domain, at its edge (within ``tol`` of the smallest cell's size, or,
    at the jet axis, where a float32 cos(theta) within ``AXIS_ULPS`` steps
    of 1 reads theta 0), or in the rounding gap a float32 lookup leaves
    between two cells at a seam."""
    c = inp.cells
    dev = pos.device

    def col(k):
        return torch.as_tensor(np.asarray(c[k], dtype=np.float64), device=dev)

    r0c, r1c, dr0, dr1 = col("r0"), col("r1"), col("dr0"), col("dr1")
    p = pos.to(torch.float64)
    r0 = torch.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2])
    r1 = torch.arccos(torch.clamp(p[:, 2] / r0, -1.0, 1.0))
    safe = torch.clamp(cell.long(), 0, r0c.shape[0] - 1)
    in_cell = ((2.0 * torch.abs(r0 - r0c[safe]) - dr0[safe] <= tol * dr0[safe])
               & (2.0 * torch.abs(r1 - r1c[safe]) - dr1[safe] <= tol * dr1[safe]))
    dom = np.asarray(inp.domain, dtype=np.float64)
    m0, m1 = tol * float(dr0.min()), tol * float(dr1.min())
    axis = math.acos(1.0 - AXIS_ULPS * 2.0 ** -24) if dom[1, 0] == 0.0 else 0.0
    deep = ((r0 > dom[0, 0] + m0) & (r0 < dom[0, 1] - m0)
            & (r1 > dom[1, 0] + max(m1, axis)) & (r1 < dom[1, 1] - m1))
    ok = torch.where(cell >= 0, in_cell, ~deep)
    # -1 inside the domain: every cell searched, for the first SEAM_CHECKS
    # of them; the rest are off
    miss = torch.nonzero(~ok & (cell < 0)).flatten()[:fm.SEAM_CHECKS]
    step = max(1, (1 << 24) // r0c.shape[0])
    for a in range(0, miss.numel(), step):
        m = miss[a:a + step]
        slack = torch.maximum((2.0 * torch.abs(r0[m, None] - r0c) - dr0) / dr0,
                              (2.0 * torch.abs(r1[m, None] - r1c) - dr1) / dr1)
        ok[m] = slack.amin(dim=1) >= -tol
    return ok
