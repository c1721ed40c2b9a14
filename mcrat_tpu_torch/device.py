"""The port's default device.

Every entry point that creates tensors (``HydroFrameHost.to_device``,
``build_rectilinear_index``, ``build_binned_index``, ``empty_photons``,
``photons_from_arrays``, ``hot_xsec.load_or_build`` and the ``convert``
bridges) takes ``device=None`` and puts them on :data:`DEFAULT_DEVICE`, the
card.  Without a card that raises: nothing falls back to the CPU.  Tests and
CPU rehearsals pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device``, or :data:`DEFAULT_DEVICE` when it is None; a CUDA device
    raises RuntimeError when torch sees no card."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"mcrat_tpu_torch puts tensors on {dev} by default and torch sees no CUDA "
            f"device; pass device='cpu' to run the plain twins on the CPU")
    return dev
