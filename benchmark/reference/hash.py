"""Counter-based uniforms of the transport round, in plain PyTorch.

Frozen copy of ``mcrat_tpu_torch/ops/rng.py:1-69`` (the interpret-mode
murmur3 stream of the MCRaT fused round), so the reference draws the number
that the program draws for the same (seed, lane, draw).  All arithmetic is
mod 2^32 in int64:

    base = u32(seed + pid * 1442695041) + u32(lane_in_block) * 0x9E3779B9
    x    = fmix32(base + u32(k * 0x85EBCA6B))
    u    = bitcast_f32((x >> 9) | 0x3F800000) - 1     in [0, 1)

``dtype`` rounds the float32 uniform to a lower working precision (the
control of the comparison); float32 returns it as drawn.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
SALT_PID = 1442695041
GOLDEN = 0x9E3779B9
STEP = 0x85EBCA6B
_FMIX1 = 0x7FEB352D
_FMIX2 = 0x846CA68B
# floor of uniform_pos (safe under log)
TINY = 1e-37


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def lane_base(seed: int, lanes: torch.Tensor, block_lanes: int) -> torch.Tensor:
    """Stream base (int64 holding a uint32) of global lane indices for one call."""
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


def uniform(base: torch.Tensor, k: int, dtype=torch.float32) -> torch.Tensor:
    """Uniform in [0, 1) from the k-th draw."""
    mant = ((bits(base, k) >> 9) | 0x3F800000).to(torch.int32)
    return (mant.view(torch.float32) - 1.0).to(dtype)


def uniform_pos(base: torch.Tensor, k: int, dtype=torch.float32) -> torch.Tensor:
    """uniform() floored at TINY."""
    return torch.clamp(uniform(base, k, dtype), min=TINY)


def rng_seed_i32(seed: int) -> int:
    """A seed wrapped to int32."""
    s = int(seed) & MASK32
    return s - (1 << 32) if s >= (1 << 31) else s
