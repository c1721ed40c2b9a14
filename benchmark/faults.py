"""Faults planted under the timed path, to show that the comparison fails
them: each replaces the program's chunk step
(``mcrat_tpu_torch.transport.transport_rounds_fused``) while it is active.

- ``unchanged``: the step returns its photons as they came, all done;
- ``half``: the step leaves the second half of the lanes out (their
  photons as they came, done);
- ``altered``: the step's answer altered where it is produced: every
  photon that scattered in the step comes out with its lab four-momentum
  ``ALTERED_GAIN`` high (still on the light cone).
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "altered")
ALTERED_GAIN = 1.1


def _done(res, photons, t_rem, keep):
    """``res`` with the lanes outside ``keep`` as they came, out of time."""
    from mcrat_tpu_torch import transport

    ph = res.photons.replace(**{k: torch.where(keep.view(-1, *[1] * (v.dim() - 1)), v,
                                               getattr(photons, k))
                                for k, v in res.photons.fields().items()})
    t_out = torch.where(keep, res.t_rem, torch.zeros_like(t_rem))
    active = ph.alive & (t_out > 0)
    return transport.ChunkResult(photons=ph, t_rem=t_out, n_scatt=res.n_scatt,
                                 n_rounds=res.n_rounds, all_done=~active.any(),
                                 n_active=active.sum())


@contextlib.contextmanager
def planted(name: str):
    """The program's chunk step broken as ``name`` says, while active."""
    from mcrat_tpu_torch import transport

    real = transport.transport_rounds_fused

    def step(cfg, photons, frame, index, t_rem, **kw):
        if name == "unchanged":
            res = transport.ChunkResult(photons=photons, t_rem=t_rem, n_scatt=torch.zeros(
                (), dtype=torch.int64, device=t_rem.device), n_rounds=kw.get("max_rounds", 0),
                all_done=torch.ones((), dtype=torch.bool, device=t_rem.device),
                n_active=torch.zeros((), dtype=torch.int64, device=t_rem.device))
            return _done(res, photons, t_rem, torch.zeros_like(t_rem, dtype=torch.bool))
        res = real(cfg, photons, frame, index, t_rem, **kw)
        if name == "half":
            keep = torch.arange(photons.capacity, device=t_rem.device) < photons.capacity // 2
            return _done(res, photons, t_rem, keep)
        if name == "altered":
            hit = res.photons.num_scatt > photons.num_scatt
            p = torch.where(hit[:, None], res.photons.p * ALTERED_GAIN, res.photons.p)
            return res._replace(photons=res.photons.replace(p=p))
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")

    transport.transport_rounds_fused = step
    try:
        yield
    finally:
        transport.transport_rounds_fused = real
