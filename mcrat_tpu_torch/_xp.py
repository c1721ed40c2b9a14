"""Array-namespace dispatch for host/device dual-use math.

Host code (injection, frame construction) works in numpy float64; device code
works on torch tensors.  Functions shared by both (geometry transforms,
Lorentz boosts) pick their namespace from their inputs, so a numpy call never
round-trips through float32 tensors -- cell volumes at GRB radii
(r^3 ~ 1e40 cm^3) overflow float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class _TorchNS:
    """The handful of numpy names the shared math uses, spelled for torch."""

    pi = math.pi
    sqrt = staticmethod(torch.sqrt)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    exp = staticmethod(torch.exp)
    log = staticmethod(torch.log)
    log1p = staticmethod(torch.log1p)
    arccos = staticmethod(torch.arccos)
    arctan2 = staticmethod(torch.atan2)
    abs = staticmethod(torch.abs)
    clip = staticmethod(torch.clamp)
    where = staticmethod(torch.where)
    zeros_like = staticmethod(torch.zeros_like)
    finfo = staticmethod(torch.finfo)

    @staticmethod
    def mod(x, m):
        return torch.remainder(x, m)

    @staticmethod
    def maximum(x, y):
        return torch.clamp(x, min=y) if not torch.is_tensor(y) else torch.maximum(x, y)

    @staticmethod
    def minimum(x, y):
        return torch.clamp(x, max=y) if not torch.is_tensor(y) else torch.minimum(x, y)


torch_ns = _TorchNS()


def xp_for(*arrays):
    """Return the torch namespace if any input is a tensor, else numpy."""
    for a in arrays:
        if torch.is_tensor(a):
            return torch_ns
    return np
