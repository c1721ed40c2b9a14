"""One frame window on an AMR cell list with hot cross sections and
power-law electrons, in plain PyTorch.

The reference of a 2-D cylindrical frame given as FLASH leaf blocks (a cell
list, Src/mclib_flash.c:60) in MCRaT's TABLE optical depth with nonthermal
electrons (TAU_CALCULATION TABLE, NONTHERMAL_E_DIST POWERLAW;
Src/mcrat.h:269-279, 340-388).  It composes what the other references
hold, editing none of them:

- the cell list, its uniform-bin index, the lookup behind each photon's
  cached cell and ``cell_holds``: ``frame.py`` (``build_frame``'s packed
  table, ``build_bin_index``, ``find_cell_rows``);
- the round with the TABLE rate and the population's electron:
  ``table.py``'s ``_rounds``, on the packed table's rows;
- the tables, sigma_hat, the subgroups' sigmas and the power-law draw:
  ``hot.py``.

As upstream (calculateOpticalDepth, Src/optical_depth.c:7-112), the biased
rate is computed anew every round, at the comoving energy after that
round's boost, in the photon's current cell; a photon that leaves its cell
stalls until the next lookup, and nothing else stalls it: there are no
per-lane rate planes and no stall after a scattering.  The electron is
drawn as ``table.py`` draws it.

The packed table holds the comoving nonthermal density in its
``nonthermal_dens`` row (calculateNonthermalElectronDens,
Src/electron.c:677-706, an input here, as the hydro frame is).  Departures
from upstream are ``table.py``'s (the population's uniform is drawn, a
subgroup with no electrons adds nothing to the biased total) and
``hot.py``'s (the tables' quadrature).

It imports nothing of the program.  ``dtype`` is the working precision.
"""
from __future__ import annotations

import numpy as np
import torch

from . import frame as fm
from . import hot
from . import rounds as rd
from . import table as tb
from .constants import KB_OVER_MEC2

cell_holds = fm.cell_holds
photons_from_arrays = fm.photons_from_arrays
Inputs = tb.Inputs


def inputs(spec: dict, host, edges, photons: dict) -> Inputs:
    """The Inputs of a configuration ``spec`` (its ``powerlaw_index``,
    ``gamma_min``, ``gamma_max``, ``n_gamma``) from its host frame, a cell
    list."""
    if edges is not None:
        raise ValueError("the AMR TABLE reference runs cell lists only")
    return Inputs(cells={k: np.asarray(getattr(host, k)) for k in tb.CELL_FIELDS},
                  domain=np.asarray(host.domain), edges=None, photons=photons,
                  dt_max=spec["frame_window_s"], stokes=spec["stokes"],
                  max_rounds=spec["max_rounds_per_frame"],
                  electrons=hot.PowerLaw(spec["powerlaw_index"], spec["gamma_min"],
                                         spec["gamma_max"], spec["n_gamma"]))


class _Cell(rd._Cell):
    """``rounds._Cell`` of the packed table, with the cell's temperature as
    theta and its lab nonthermal density (``table._Cell``'s fields)."""

    def __init__(self, table, cl, grid: rd.Grid):
        super().__init__("packed", table, cl, grid)
        self.theta = self.temp * KB_OVER_MEC2
        row = table[:, cl]
        self.n_nt = row[rd.PCOL["nonthermal_dens"]] * row[rd.PCOL["gamma"]]


def transport_window(inp: Inputs, generator: torch.Generator, device, dtype=torch.float32,
                     tally=None) -> tuple:
    """The population after one frame window of ``dt_max``: (photons dict,
    t_rem), as ``frame.transport_window`` runs a cell list (calls of
    ``inner_rounds`` rounds on the photons with time left, each photon
    looked up before a call only where it left its cached cell), with
    ``table.py``'s rounds and the hot tables ``hot.build`` makes on
    ``device``.  ``tally`` (a dict) receives the scatterings by
    population."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tables = hot.build(inp.electrons, str(device))
    frame = fm.build_frame(inp, device, dtype)
    frame.table[rd.PCOL["nonthermal_dens"]] = torch.as_tensor(
        np.asarray(inp.cells["nonthermal_dens"]), dtype=dtype, device=device)
    index = fm.build_bin_index(inp.cells, device, dtype)
    grid = fm.grid_scalars(frame, index)
    ph = photons_from_arrays(inp.photons, device, dtype)
    al = fm.alive(ph)
    pool = ph["ptype"] == fm.POOL_TYPE
    promoted_any = torch.zeros_like(al)
    zero = torch.zeros((), dtype=dtype, device=device)
    state = fm._planes(ph, torch.where(al, torch.as_tensor(inp.dt_max, dtype=dtype,
                                                           device=device), zero))
    cell = ph["cell"].clone()

    def pos(lanes=None):
        st = state[rd.SP_X: rd.SP_Z + 1]
        return (st if lanes is None else st[:, lanes]).T

    rounds_done = 0
    while rounds_done < inp.max_rounds:
        lanes = torch.nonzero(al & (state[rd.SP_TREM] > 0)).flatten()
        if lanes.numel() == 0:
            break
        found, in_grid = fm.find_cell_rows(index, frame, pos(lanes), cell[lanes])
        cell[lanes] = found
        flags = fm.lane_flags(al[lanes], pool[lanes], in_grid)
        cl = torch.clamp(found.long(), 0, frame.num_elements - 1)
        base = rd.rng.lane_base(rd.rng.rng_seed_i32(fm.draw_seed(generator)), lanes, 16384)
        sub = state[:, lanes]
        planes, _, promoted = tb._rounds(
            tuple(sub[i] for i in range(rd.N_STATE)), (flags & rd.FLAG_ALIVE) != 0,
            (flags & rd.FLAG_POOL) != 0, (flags & rd.FLAG_INGRID) != 0,
            _Cell(frame.table, cl, grid), base, tables, inp.electrons, inp.stokes,
            inp.inner_rounds, dtype, tally)
        state[:, lanes] = torch.stack(planes)
        pool[lanes] = pool[lanes] & ~promoted
        promoted_any[lanes] = promoted_any[lanes] | promoted
        rounds_done += inp.inner_rounds
    cell, _ = fm.find_cell_rows(index, frame, pos(), cell)

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
