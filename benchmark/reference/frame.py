"""One transport frame window of a photon population, in plain PyTorch.

The reference the benchmark holds the program's timed path to, for 2-D
cylindrical frames on a uniform rectilinear grid or an AMR cell list.  From
the benchmark's own inputs (the hydro frame's cell arrays and the injected
photons, numpy float64) it builds its own cell tables and cell lookups and
runs the window: calls of a few transport rounds on the photons with time
left, a lookup before each.  Which random numbers a photon draws is its own
business, not the program's (no lanes, partition or compaction of the
program's are copied), so the two agree in distribution, not photon for
photon.  Frozen copies of the program's:

- cell tables: ``mcrat_tpu_torch/grid.py`` ``HydroFrameHost.packed_slim``
  / ``packed`` / ``to_device`` (:208-292);
- lookups: ``RectilinearIndex.axis_index`` / ``find`` (:315-343),
  ``build_rectilinear_index`` (:351-371), ``BinnedIndex`` (:385-461),
  ``build_binned_index`` (:464-520), ``_hydro_inside``, ``find_cell_rows``,
  ``find_cell_direct`` (:523-580), ``geometry.in_block`` (:192-201);
- glue: ``mcrat_tpu_torch/transport.py`` ``grid_scalars`` (:663-677),
  ``draw_seed`` (:679-684), ``lane_flags`` (:737-741),
  ``photons_from_arrays`` (:299-327).

It imports nothing of the program.  ``dtype`` is the working precision.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import rounds as rd
from .constants import M_P

NULL_TYPE = 5  # the photon type of an empty slot
POOL_TYPE = 2  # a cyclo-synchrotron pool photon
COMPTONIZED_TYPE = 1
FIELDS = ("p", "comv_p", "pos", "s", "weight", "num_scatt", "cell", "ptype")
SEAM_CHECKS = 4096
CELL_FIELDS = ("r0", "r1", "dr0", "dr1", "v0", "v1", "gamma", "dens_lab", "temp")


@dataclasses.dataclass
class Inputs:
    """What the benchmark hands to the program and to the reference alike.

    ``cells`` holds the frame's (Ncell,) float64 columns ``CELL_FIELDS``;
    ``domain`` its (3, 2) bounds; ``edges`` the (r0, r1) edges of a uniform
    rectilinear grid, or None for a cell list; ``photons`` the injected
    arrays (p, comv_p, pos, s, weight, num_scatt, cell, ptype)."""

    cells: dict
    domain: np.ndarray
    edges: Optional[tuple]
    photons: dict
    dt_max: float
    stokes: bool = True
    max_rounds: int = 2_000_000
    inner_rounds: int = 4


def inputs(spec: dict, host, edges, photons: dict) -> Inputs:
    """The Inputs of a configuration ``spec`` from its host frame (any
    object with the ``CELL_FIELDS`` and ``domain`` as numpy arrays)."""
    return Inputs(cells={k: np.asarray(getattr(host, k)) for k in CELL_FIELDS},
                  domain=np.asarray(host.domain), edges=edges, photons=photons,
                  dt_max=spec["frame_window_s"], stokes=spec["stokes"],
                  max_rounds=spec["max_rounds_per_frame"])


# ---------------------------------------------------------------------------
# cell tables and lookups
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Frame:
    r0: torch.Tensor
    r1: torch.Tensor
    dr0: torch.Tensor
    dr1: torch.Tensor
    domain: torch.Tensor
    table: torch.Tensor
    source: str  # "ultra" (uniform grid) or "packed" (cell list)

    @property
    def num_elements(self) -> int:
        return self.r0.shape[0]


def build_frame(inp: Inputs, device, dtype) -> Frame:
    c = inp.cells
    n = len(c["r0"])

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    if inp.edges is not None:
        source = "ultra"
        table = put(np.stack([c["v0"], c["v1"], c["dens_lab"] * (1.0 / M_P), c["temp"]]))
    else:
        source = "packed"
        z = np.zeros(n)
        cols = [c["r0"], c["r1"], z, c["dr0"], c["dr1"], z, c["v0"], c["v1"], z, c["gamma"],
                c["dens_lab"], c["temp"], z, np.sin(c["r1"]), np.cos(c["r1"]), z]
        table = put(np.stack(cols))
    return Frame(r0=put(c["r0"]), r1=put(c["r1"]), dr0=put(c["dr0"]), dr1=put(c["dr1"]),
                 domain=put(inp.domain), table=table.contiguous(), source=source)


@dataclasses.dataclass
class UniformIndex:
    """Cell (i, j) of a uniform 2-D grid, cell = i * n1 + j."""

    edges0: torch.Tensor
    edges1: torch.Tensor
    lo: torch.Tensor
    inv_d: torch.Tensor

    def axis_index(self, axis: int, x):
        edges = (self.edges0, self.edges1)[axis]
        n = edges.shape[0] - 1
        i = torch.floor((x - self.lo[axis]) * self.inv_d[axis]).to(torch.int32)
        return torch.clamp(i, 0, n - 1)

    def find(self, r0, r1, frame=None):
        n1 = self.edges1.shape[0] - 1
        i = self.axis_index(0, r0)
        j = self.axis_index(1, r1)
        inside = ((r0 >= self.edges0[0]) & (r0 <= self.edges0[-1])
                  & (r1 >= self.edges1[0]) & (r1 <= self.edges1[-1]))
        return torch.where(inside, i * n1 + j, -1)


def build_uniform_index(edges, device, dtype) -> UniformIndex:
    e0, e1 = (np.asarray(e, dtype=np.float64) for e in edges)
    for e in (e0, e1):
        d = np.diff(e)
        if not np.allclose(d, d[0], rtol=1e-5, atol=0.0):
            raise ValueError("the reference's rectilinear lookup runs uniform grids only")
    e2 = np.array([0.0, 1.0])
    lo = np.array([e0[0], e1[0], e2[0]])
    d = np.array([(e[-1] - e[0]) / max(e.size - 1, 1) for e in (e0, e1, e2)])
    inv_d = 1.0 / np.where(d > 0, d, 1.0)

    def put(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return UniformIndex(edges0=put(e0), edges1=put(e1), lo=put(lo), inv_d=put(inv_d))


def in_block(r0, r1, c0, c1, s0, s1):
    """AABB point-in-cell test, 2|x - c| - size <= 0 per axis."""
    return (2.0 * torch.abs(r0 - c0) - s0 <= 0) & (2.0 * torch.abs(r1 - c1) - s1 <= 0)


# bytes of live temporaries a (lane, candidate) pair of the binned search
# holds, and the budget the search's lane chunks keep to
_SEARCH_BYTES_PER_CANDIDATE = 128
SEARCH_BUDGET_BYTES = 256 << 20


@dataclasses.dataclass
class BinIndex:
    """Uniform-bin CSR index over a 2-D cell list: cells counting-sorted
    into bins no smaller than the largest cell, so a containing cell's
    centre lies within one bin of the point; bin b holds
    ``cell_ids[bin_start[b]: bin_start[b] + bin_count[b]]``."""

    cell_ids: torch.Tensor
    bin_start: torch.Tensor
    bin_count: torch.Tensor
    grid_min: torch.Tensor
    inv_bin: torch.Tensor
    dims: tuple
    max_slab: int

    def _bin(self, x, axis: int):
        d = self.dims[axis]
        f = (x - self.grid_min[axis]) * self.inv_bin[axis]
        f = torch.clamp(torch.nan_to_num(f, nan=0.0), -1.0, float(d))
        return torch.clamp(f.to(torch.int64), 0, d - 1)

    def _find_chunk(self, r0, r1, frame: Frame):
        d0, d1, _ = self.dims
        i, j = self._bin(r0, 0), self._bin(r1, 1)
        ncell = self.cell_ids.shape[0]
        found = torch.full(r0.shape, -1, dtype=torch.int32, device=r0.device)
        slab = torch.arange(self.max_slab, device=r0.device)
        p0, p1 = r0[:, None], r1[:, None]
        # neighbour order (dy, dx) and the first hit within a bin
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ii = torch.clamp(i + dx, 0, d0 - 1)
                jj = torch.clamp(j + dy, 0, d1 - 1)
                flat = jj * d0 + ii
                start = self.bin_start[flat].to(torch.int64)
                count = self.bin_count[flat].to(torch.int64)
                gidx = torch.clamp(start[:, None] + slab, 0, ncell - 1)
                cand = self.cell_ids[gidx].to(torch.int64)
                ok = in_block(p0, p1, frame.r0[cand], frame.r1[cand], frame.dr0[cand],
                              frame.dr1[cand])
                ok = ok & (slab < count[:, None])
                hit = torch.argmax(ok.to(torch.uint8), dim=-1, keepdim=True)
                cand_hit = torch.gather(cand, 1, hit)[:, 0].to(torch.int32)
                found = torch.where((found < 0) & ok.any(dim=-1), cand_hit, found)
        return found

    def find(self, r0, r1, frame: Frame):
        chunk = max(1, SEARCH_BUDGET_BYTES // (_SEARCH_BYTES_PER_CANDIDATE * self.max_slab))
        n = r0.shape[0]
        if n <= chunk:
            return self._find_chunk(r0, r1, frame)
        return torch.cat([self._find_chunk(r0[a:a + chunk], r1[a:a + chunk], frame)
                          for a in range(0, n, chunk)])


def build_bin_index(cells: dict, device, dtype, target_bins: int = 1 << 20) -> BinIndex:
    r0, r1, dr0, dr1 = (np.asarray(cells[k], dtype=np.float64) for k in ("r0", "r1", "dr0", "dr1"))
    lo = np.array([(r0 - dr0 / 2).min(), (r1 - dr1 / 2).min(), 0.0])
    hi = np.array([(r0 + dr0 / 2).max(), (r1 + dr1 / 2).max(), 1.0])
    span = np.maximum(hi - lo, 1e-300)
    max_cell = np.array([dr0.max(), dr1.max(), span[2]])
    per_axis = max(1, int(round(target_bins ** 0.5)))
    bin_size = np.maximum(span / per_axis, max_cell)
    dims = np.maximum((span / bin_size).astype(int), 1)
    dims[2] = 1
    bin_size[2] = span[2]
    inv_bin = 1.0 / bin_size
    i = np.clip(((r0 - lo[0]) * inv_bin[0]).astype(np.int64), 0, dims[0] - 1)
    j = np.clip(((r1 - lo[1]) * inv_bin[1]).astype(np.int64), 0, dims[1] - 1)
    flat = j * dims[0] + i
    order = np.argsort(flat, kind="stable").astype(np.int32)
    counts = np.bincount(flat, minlength=int(dims.prod())).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return BinIndex(
        cell_ids=torch.as_tensor(order, device=device),
        bin_start=torch.as_tensor(starts, device=device),
        bin_count=torch.as_tensor(counts, device=device),
        grid_min=torch.as_tensor(lo, dtype=dtype, device=device),
        inv_bin=torch.as_tensor(inv_bin, dtype=dtype, device=device),
        dims=(int(dims[0]), int(dims[1]), int(dims[2])),
        max_slab=int(max(counts.max(), 1)),
    )


def _hydro_inside(frame: Frame, pos):
    """Cylindrical (r, z) of (N, 3) positions and the strict domain test."""
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    r0 = torch.sqrt(x * x + y * y)
    r1 = z
    dom = frame.domain
    inside = (r0 > dom[0, 0]) & (r0 < dom[0, 1]) & (r1 > dom[1, 0]) & (r1 < dom[1, 1])
    return r0, r1, inside


def find_cell_direct(index: UniformIndex, frame: Frame, pos):
    r0, r1, inside = _hydro_inside(frame, pos)
    cell = torch.where(inside, index.find(r0, r1), -1).to(torch.int32)
    return cell, inside & (cell >= 0)


def find_cell_rows(index: BinIndex, frame: Frame, pos, cached):
    """A photon still inside its cached cell keeps it; the index searches
    the others.  Out-of-domain photons get -1."""
    r0, r1, inside = _hydro_inside(frame, pos)
    safe = torch.clamp(cached, 0, frame.num_elements - 1).to(torch.int64)
    in_cached = (cached >= 0) & in_block(r0, r1, frame.r0[safe], frame.r1[safe],
                                         frame.dr0[safe], frame.dr1[safe])
    cell = torch.where(in_cached, cached.to(torch.int32), -1)
    miss = torch.nonzero(~in_cached & inside).flatten()
    if miss.numel():
        cell[miss] = index.find(r0[miss], r1[miss], frame).to(torch.int32)
    cell = torch.where(inside, cell, -1)
    return cell, inside & (cell >= 0)


def grid_scalars(frame: Frame, index) -> rd.Grid:
    dom = frame.domain.to(torch.float32).reshape(-1)
    if isinstance(index, BinIndex):
        v = dom.tolist()
        return rd.Grid(*v[:4])
    lo = index.lo.float()
    d = [(e[1] - e[0]).float() for e in (index.edges0, index.edges1)]
    v = torch.stack([*dom[:4], lo[0], d[0], lo[1], d[1]]).tolist()
    return rd.Grid(*v[:4], lo0=v[4], d0=v[5], lo1=v[6], d1=v[7],
                   n1=index.edges1.shape[0] - 1)


# ---------------------------------------------------------------------------
# photons and the window
# ---------------------------------------------------------------------------


def photons_from_arrays(arrays: dict, device, dtype) -> dict:
    """The injected arrays packed into (N, k) tensors; weights normalized
    by their median."""
    w = np.asarray(arrays["weight"])
    norm = float(np.median(w)) or 1.0
    out = {}
    for k in FIELDS:
        val = np.asarray(arrays[k])
        if k == "weight":
            val = val / norm
        tdtype = torch.int32 if k in ("cell", "ptype") else dtype
        out[k] = torch.as_tensor(val, dtype=tdtype, device=device)
    return out


def alive(ph: dict):
    return (ph["weight"] > 0) & (ph["ptype"] != NULL_TYPE)


def draw_seed(generator: torch.Generator) -> int:
    """One int32 seed from a CPU generator."""
    return int(torch.randint(-(2**31), 2**31 - 1, (1,), generator=generator,
                             dtype=torch.int64).item())


def _planes(ph: dict, t_rem):
    """Photons -> (16, N) state planes."""
    state = torch.empty((rd.N_STATE, ph["p"].shape[0]), dtype=ph["p"].dtype,
                        device=ph["p"].device)
    state[rd.SP_P0: rd.SP_P3 + 1] = ph["p"].T
    state[rd.SP_X: rd.SP_Z + 1] = ph["pos"].T
    state[rd.SP_Q: rd.SP_V + 1] = ph["s"][:, 1:].T
    state[rd.SP_TREM] = t_rem
    state[rd.SP_NS] = ph["num_scatt"]
    state[rd.SP_C0: rd.SP_C3 + 1] = ph["comv_p"].T
    return state


def lane_flags(al, pool, in_grid):
    return (al.to(torch.int32) * rd.FLAG_ALIVE + pool.to(torch.int32) * rd.FLAG_POOL
            + in_grid.to(torch.int32) * rd.FLAG_INGRID)


def transport_window(inp: Inputs, generator: torch.Generator, device,
                     dtype=torch.float32) -> tuple:
    """The population after one frame window of ``dt_max``: (photons dict,
    t_rem).  Calls of ``inner_rounds`` rounds run on the photons with time
    left, each photon drawing the counter stream of (the call's seed, its
    index), each call's seed drawn from ``generator`` (a CPU
    torch.Generator); before each call the photons are looked up (on a
    cell list only those that left their cached cell), so a photon that
    left its cell, stalled, goes on in the next."""
    frame = build_frame(inp, device, dtype)
    if inp.edges is not None:
        index = build_uniform_index(inp.edges, device, dtype)
    else:
        index = build_bin_index(inp.cells, device, dtype)
    carried = isinstance(index, BinIndex)
    grid = grid_scalars(frame, index)
    ph = photons_from_arrays(inp.photons, device, dtype)
    al = alive(ph)
    pool = ph["ptype"] == POOL_TYPE
    promoted_any = torch.zeros_like(al)
    dt = torch.as_tensor(inp.dt_max, dtype=dtype, device=device)
    state = _planes(ph, torch.where(al, dt, torch.zeros((), dtype=dtype, device=device)))
    cell = ph["cell"].clone()

    def pos(lanes=None):
        st = state[rd.SP_X: rd.SP_Z + 1]
        return (st if lanes is None else st[:, lanes]).T

    rounds_done = 0
    while rounds_done < inp.max_rounds:
        lanes = torch.nonzero(al & (state[rd.SP_TREM] > 0)).flatten()
        if lanes.numel() == 0:
            break
        if carried:
            found, in_grid = find_cell_rows(index, frame, pos(lanes), cell[lanes])
        else:
            found, in_grid = find_cell_direct(index, frame, pos(lanes))
        cell[lanes] = found
        _, promoted = rd.rounds(state, lanes, found, lane_flags(al[lanes], pool[lanes], in_grid),
                                frame.table, rd.rng.rng_seed_i32(draw_seed(generator)), grid,
                                frame.source, stokes_on=inp.stokes,
                                inner_rounds=inp.inner_rounds)
        pool[lanes] = pool[lanes] & ~promoted
        promoted_any[lanes] = promoted_any[lanes] | promoted
        rounds_done += inp.inner_rounds
    if carried:
        cell, _ = find_cell_rows(index, frame, pos(), cell)
    else:
        cell, _ = find_cell_direct(index, frame, pos())

    def unplane(lo, hi):
        return state[lo:hi].T.contiguous()

    ones = torch.ones((state.shape[1], 1), dtype=state.dtype, device=device)
    out = dict(ph, p=unplane(rd.SP_P0, rd.SP_P3 + 1), pos=unplane(rd.SP_X, rd.SP_Z + 1),
               s=torch.cat([ones, unplane(rd.SP_Q, rd.SP_V + 1)], dim=1),
               num_scatt=state[rd.SP_NS].clone(), comv_p=unplane(rd.SP_C0, rd.SP_C3 + 1),
               cell=cell.to(torch.int32),
               ptype=torch.where(promoted_any & (ph["ptype"] == POOL_TYPE), COMPTONIZED_TYPE,
                                 ph["ptype"]).to(torch.int32))
    return out, state[rd.SP_TREM].clone()


def cell_holds(inp: Inputs, pos, cell, tol: float = 1e-2):
    """Which photons' cell is theirs: a cell >= 0 holds the (N, 3) position
    to ``tol`` of the cell's size on each axis; -1 only where no cell holds
    it by more than ``tol`` of its size: outside the domain, at its edge,
    or in the rounding gap a float32 lookup leaves between the boxes of two
    cells at a seam."""
    c = inp.cells
    dev = pos.device

    def col(k):
        return torch.as_tensor(np.asarray(c[k], dtype=np.float64), device=dev)

    r0c, r1c, dr0, dr1 = col("r0"), col("r1"), col("dr0"), col("dr1")
    p = pos.to(torch.float64)
    r0 = torch.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1])
    r1 = p[:, 2]
    safe = torch.clamp(cell.long(), 0, r0c.shape[0] - 1)
    in_cell = ((2.0 * torch.abs(r0 - r0c[safe]) - dr0[safe] <= tol * dr0[safe])
               & (2.0 * torch.abs(r1 - r1c[safe]) - dr1[safe] <= tol * dr1[safe]))
    dom = np.asarray(inp.domain, dtype=np.float64)
    m0, m1 = tol * float(dr0.min()), tol * float(dr1.min())
    deep = ((r0 > dom[0, 0] + m0) & (r0 < dom[0, 1] - m0)
            & (r1 > dom[1, 0] + m1) & (r1 < dom[1, 1] - m1))
    ok = torch.where(cell >= 0, in_cell, ~deep)
    # -1 inside the domain: every cell searched, for the first SEAM_CHECKS
    # of them (a sound window has a few per 10^5 photons); the rest are off
    miss = torch.nonzero(~ok & (cell < 0)).flatten()[:SEAM_CHECKS]
    step = max(1, (1 << 24) // r0c.shape[0])
    for a in range(0, miss.numel(), step):
        m = miss[a:a + step]
        slack = torch.maximum((2.0 * torch.abs(r0[m, None] - r0c) - dr0) / dr0,
                              (2.0 * torch.abs(r1[m, None] - r1c) - dr1) / dr1)
        ok[m] = slack.amin(dim=1) >= -tol
    return ok
