"""Counter-based uniforms shared by the fused-round twin and its CUDA kernel.

The stream is the interpret-mode hash of the JAX kernel
(``mcrat_tpu/ops/pallas_round.py::_Rng``), so the twin, the kernel and the
JAX kernel in interpret mode draw the same number for the same
(seed, lane, draw) and can be held against each other lane for lane.  All
arithmetic is mod 2^32:

    base = u32(seed + pid * 1442695041) + u32(lane_in_block) * 0x9E3779B9
    x    = base + u32(k * 0x85EBCA6B)                 (k = 1, 2, ... per draw)
    x    = fmix32(x)                                  (murmur3 finalizer)
    u    = bitcast_f32((x >> 9) | 0x3F800000) - 1     in [0, 1)

``pid`` is the lane's logical block (``lane // block_lanes``) and ``k`` the
static draw number in the invocation's program order.  The twin works in
int64 and splits every 32-bit multiply into 16-bit halves, so no product
leaves the int64 range.  ``csrc/fused_round.cu`` transcribes the same
arithmetic in uint32.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
SALT_PID = 1442695041
GOLDEN = 0x9E3779B9
STEP = 0x85EBCA6B
_FMIX1 = 0x7FEB352D
_FMIX2 = 0x846CA68B
# float32 floor of uniform_pos (pallas_round._TINY)
TINY = 1e-37


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def lane_base(seed: int, lanes: torch.Tensor, block_lanes: int) -> torch.Tensor:
    """Stream base (int64 holding a uint32) of the given global lane indices
    for one invocation."""
    lane = lanes.to(torch.int64)
    pid = torch.div(lane, block_lanes, rounding_mode="floor")
    lane_in = lane - pid * block_lanes
    salted = (int(seed) + pid * SALT_PID) & MASK32
    return (salted + _mul32(lane_in, GOLDEN)) & MASK32


def bits(base: torch.Tensor, k: int) -> torch.Tensor:
    """fmix32 of the k-th counter of every lane (int64 holding a uint32)."""
    x = (base + ((k * STEP) & MASK32)) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, _FMIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _FMIX2)
    return x ^ (x >> 16)


def uniform(base: torch.Tensor, k: int) -> torch.Tensor:
    """float32 uniform in [0, 1) from the k-th draw."""
    mant = ((bits(base, k) >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def uniform_pos(base: torch.Tensor, k: int) -> torch.Tensor:
    """uniform() floored at TINY (safe under log)."""
    return torch.clamp(uniform(base, k), min=TINY)
