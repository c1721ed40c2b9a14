"""Traffic kind ``frame_repeat_table``: ``frame_repeat``'s windows in TABLE
optical depth.

The same population, set-up and windows as ``frame_repeat`` (its module,
loaded here), with the hot cross-section tables built in set-up
(``ops.hot_xsec.load_or_build`` with no cache file, so every run's set-up
counts the same build) and handed to every window as ``xsec_table``.  Its
mixes give ``frame_repeat``'s parameters.
"""
from __future__ import annotations

import dataclasses
import gc
from pathlib import Path

import torch

from benchmark import compare
from benchmark import spec as sp

base = sp.load_module(Path(__file__).with_name("frame_repeat.py"), "benchmark_kind_frame_repeat")
PARAMS = base.PARAMS
fields, before, reference_generator = base.fields, base.before, base.reference_generator


@dataclasses.dataclass
class Problem(base.Problem):
    """``frame_repeat``'s Problem and the program's hot tables."""

    xsec: object = None

    def free(self) -> None:
        super().free()
        self.xsec = None


def setup(spec: dict, config, mix, seed: int, device) -> Problem:
    """``frame_repeat``'s set-up, then the configuration's hot tables,
    built on ``device``."""
    from mcrat_tpu_torch.ops import hot_xsec

    prob = base.setup(spec, config, mix, seed, device)
    xsec = hot_xsec.load_or_build(prob.cfg, None, device=device)
    return Problem(**{f.name: getattr(prob, f.name) for f in dataclasses.fields(prob)},
                   xsec=xsec)


def window(prob: Problem, generator: torch.Generator):
    """One frame window of the program with the hot tables."""
    from mcrat_tpu_torch import transport

    return transport.transport_frame(
        prob.cfg, prob.photons, prob.frame, prob.index, prob.dt_max, generator=generator,
        stokes_on=prob.stokes, chunk_rounds=prob.chunk_rounds, xsec_table=prob.xsec,
        fused=True if prob.photons.device.type == "cpu" else None)


def check(prob: Problem, config, state, seed: int, device) -> dict:
    """``frame_repeat.check`` with this kind's window: the kept window run
    again on the program, the program's state freed, then the reference's
    window from the same inputs on its own stream, compared."""
    g = torch.Generator()
    g.set_state(state)
    res = window(prob, g)
    prog, n_scatt = fields(res), int(res.n_scatt)
    del res
    prob.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    inp = prob.inputs
    ref_ph, ref_t = config.reference.transport_window(inp, reference_generator(seed), device)
    return compare.compare(before(prob, config, device), prog, dict(ref_ph, t_rem=ref_t), n_scatt,
                           prob.dt_max,
                           lambda pos, cell: config.reference.cell_holds(inp, pos, cell))
