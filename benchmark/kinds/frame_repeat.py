"""Traffic kind ``frame_repeat``: one population, frame window after frame
window.

Set-up injects one population from the seed (the program's own
``transport.inject_photons``, with the configuration's injection parameters
and the mix's photon bounds) and puts it on the device.  Every window is
one ``transport.transport_frame`` call of the configuration's frame window
on that same population (the program never writes its input), drawing new
numbers from one generator that advances.  It stands for the injection
frames of a run, its heaviest, and stays steady where a chained population
would leave the grid.

A mix of this kind gives ``min_photons``, ``max_photons`` (the injection
bounds) and ``chunk_rounds`` (transport rounds between the frame's host
fetches), besides the keys every mix gives (``traffic.py``).
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from benchmark import compare
from benchmark import traffic as tf

PARAMS = ("min_photons", "max_photons", "chunk_rounds")
FIELDS = ("p", "comv_p", "pos", "s", "weight", "num_scatt", "cell", "ptype")


@dataclasses.dataclass
class Problem:
    """One cell's program objects and the inputs handed to both sides."""

    cfg: object
    frame: object
    index: object
    photons: object
    n_photons: int
    n_cells_held: int  # distinct cells holding a photon at the window's start
    inputs: object  # the reference's Inputs
    dt_max: float
    stokes: bool
    chunk_rounds: int

    def free(self) -> None:
        """Drop the program's objects (the inputs stay)."""
        self.cfg = self.frame = self.index = self.photons = None


def inject(host, injection: dict, params: dict, seed: int) -> dict:
    """The population's host arrays: the program's own injection
    (``transport.inject_photons``, numpy float64) from ``seed``."""
    from mcrat_tpu_torch import Spectrum, transport

    arrays, _ = transport.inject_photons(
        host, r_inj=injection["r_inj"], ph_weight=injection["ph_weight"],
        min_photons=params["min_photons"], max_photons=params["max_photons"],
        spect=Spectrum[injection["spectrum"]], theta_min=injection["theta_min"],
        theta_max=injection["theta_max"], fps=injection["fps"],
        rng=np.random.default_rng(tf.host_seed(seed)))
    return arrays


def setup(spec: dict, config, mix: tf.Mix, seed: int, device) -> Problem:
    """The host frame, its index, the frame and the injected population on
    ``device``, from the configuration and the mix."""
    from mcrat_tpu_torch import grid, transport

    cfg, host, edges = config.build_host(spec)
    if edges is not None:
        index = grid.build_rectilinear_index(*edges, device=device)
    else:
        index = grid.build_binned_index(host, device=device)
    frame = host.to_device(device)
    arrays = inject(host, spec["injection"], mix.params, seed)
    photons, _ = transport.photons_from_arrays(arrays, device=device)
    n_cells = int(torch.unique(photons.cell).numel())
    return Problem(cfg, frame, index, photons, len(arrays["weight"]), n_cells,
                   config.reference.inputs(spec, host, edges, arrays), spec["frame_window_s"],
                   spec["stokes"], mix.params["chunk_rounds"])


def window(prob: Problem, generator: torch.Generator):
    """One frame window of the program on the cell's population: the engine
    the program chooses, its plain twin on CPU tensors."""
    from mcrat_tpu_torch import transport

    return transport.transport_frame(
        prob.cfg, prob.photons, prob.frame, prob.index, prob.dt_max, generator=generator,
        stokes_on=prob.stokes, chunk_rounds=prob.chunk_rounds,
        fused=True if prob.photons.device.type == "cpu" else None)


def fields(res) -> dict:
    """A copy of a window's population fields and frame time left."""
    out = {k: getattr(res.photons, k).detach().clone() for k in FIELDS}
    out["t_rem"] = res.t_rem.detach().clone()
    return out


def reference_generator(seed: int) -> torch.Generator:
    """The reference's own generator: a stream apart from the program's
    (``manual_seed(seed mod 2^63)``)."""
    return torch.Generator().manual_seed((int(seed) * 6364136223846793005
                                          + 1442695040888963407) % (1 << 63))


def before(prob: Problem, config, device) -> dict:
    """The window's input population, from the benchmark's inputs."""
    return config.reference.photons_from_arrays(prob.inputs.photons, device, torch.float32)


def check(prob: Problem, config, state, seed: int, device) -> dict:
    """The window that ran from generator state ``state``, run again on the
    program once the measured window has closed, then the program's state
    freed and the reference's window from the same inputs on its own
    stream: the compared numbers (``compare.compare``)."""
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
