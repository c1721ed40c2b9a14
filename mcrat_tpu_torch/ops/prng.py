"""Threefry-2x32 keys in PyTorch: the counterpart of ``jax.random`` as the
XLA engine's samplers use it (``mcrat_tpu/ops/rng.py``).

With the same key the port draws JAX's numbers bit for bit, under JAX's
default ``jax_threefry_partitionable=True`` layout (``jax/_src/prng.py``:
``threefry_2x32``, ``_threefry_split_foldlike``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py::_uniform``):

* element ``i`` of a draw of shape ``S`` hashes the 64-bit counter
  ``(hi, lo) = (i >> 32, i & 0xFFFFFFFF)`` of its C-order flat index under
  the key, giving two words ``(b1, b2)``;
* ``split(n)``: key ``j`` is ``(b1, b2)`` of counter ``j``; ``fold_in(d)``
  hashes the counter ``(0, d)``, so ``fold_in(j)`` equals ``split(n)[j]``;
* 32-bit draws take ``b1 ^ b2``, 64-bit draws ``(b1 << 32) | b2``; a float
  keeps the top mantissa bits under the exponent of 1.0, minus 1, scaled to
  ``[minval, maxval)`` and floored at ``minval``.

Words are uint32 values held in int64 tensors and masked to 32 bits after
every add and shift (torch's ``>>`` on int64 is arithmetic; the values stay
non-negative, so it acts as a logical shift).  A :class:`Key` may hold a
batch of keys (``data`` of shape ``(*batch, 2)``); a draw of shape ``S``
then has shape ``(*batch, *S)``, each key drawing what it would alone.
:func:`batched_rejection` uses that to run every trial of a rejection loop
at once.

The JAX driver's default ``rbg`` key (the TPU's hardware generator) is not
ported: the port's XLA engine runs on threefry keys only.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32 = 0x3F800000
_ONE_F64 = 0x3FF0000000000000


def threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x0, x1)`` under
    key words ``(k1, k2)``: int64 tensors holding uint32 values, broadcast
    against each other.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            hi = torch.bitwise_left_shift(x1, r).bitwise_and_(MASK32)
            x1 = x1.bitwise_right_shift(32 - r).bitwise_or_(hi).bitwise_xor_(x0)
        x0 = (x0 + ks[(group + 1) % 3]) & MASK32
        x1 = (x1 + (ks[(group + 2) % 3] + group + 1)) & MASK32
    return x0, x1


class Key:
    """A threefry key, or a batch of them: ``data`` (*batch, 2) int64 holding
    the two uint32 key words, on the device the draws run on."""

    def __init__(self, data: torch.Tensor):
        self.data = data

    @classmethod
    def from_seed(cls, seed: int, device=None) -> "Key":
        """``jax.random.key(seed, impl="threefry2x32")``: the words
        ``(seed >> 32, seed & 0xFFFFFFFF)`` of the seed as a 64-bit integer."""
        s = int(seed) & ((1 << 64) - 1)
        return cls(torch.tensor([s >> 32, s & MASK32], dtype=torch.int64, device=device))

    @classmethod
    def from_state(cls, words, device=None) -> "Key":
        """A key from its two words (:meth:`state`, a checkpoint field)."""
        return cls(torch.as_tensor(np.asarray(words, dtype=np.int64), device=device))

    def state(self) -> np.ndarray:
        """The key words as uint32 numpy (``jax.random.key_data``)."""
        return self.data.cpu().numpy().astype(np.uint32)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def batch(self) -> tuple:
        return tuple(self.data.shape[:-1])

    def _words(self, extra: int):
        """The key words shaped to broadcast over ``extra`` trailing dims."""
        view = self.data.reshape(self.batch + (1,) * extra + (2,))
        return view[..., 0], view[..., 1]

    def _hash(self, lo: torch.Tensor, hi=None):
        """(b1, b2) of the counters ``(hi, lo)`` (hi 0 when None); ``lo`` has
        the draw's shape, the output ``(*batch, *lo.shape)``."""
        k1, k2 = self._words(lo.dim())
        shape = self.batch + tuple(lo.shape)
        x0 = torch.zeros(shape, dtype=torch.int64, device=self.device)
        if hi is not None:
            x0 = x0 + hi
        return threefry2x32(k1, k2, x0, lo.expand(shape))

    def split(self, n: int = 2) -> Tuple["Key", ...]:
        """``jax.random.split(key, n)``: n keys, each with this key's batch."""
        lo = torch.arange(n, dtype=torch.int64, device=self.device)
        b1, b2 = self._hash(lo)
        data = torch.stack([b1, b2], dim=-1)
        return tuple(Key(data[..., i, :]) for i in range(n))

    def fold_in(self, i: int) -> "Key":
        """``jax.random.fold_in(key, i)`` for 0 <= i < 2**32."""
        lo = torch.full((), int(i) & MASK32, dtype=torch.int64, device=self.device)
        b1, b2 = self._hash(lo)
        return Key(torch.stack([b1, b2], dim=-1))

    def fold_in_range(self, n: int) -> "Key":
        """``fold_in(i)`` for i = 0..n-1 in one hash: a key batch of shape
        ``(n, *batch)``."""
        lo = torch.arange(n, dtype=torch.int64, device=self.device)
        b1, b2 = self._hash(lo)
        data = torch.stack([b1, b2], dim=-1)  # (*batch, n, 2)
        return Key(torch.movedim(data, -2, 0))

    def bits(self, shape: Sequence[int]):
        """The two words (b1, b2) of every element of a draw of ``shape``."""
        shape = tuple(int(s) for s in shape)
        size = math.prod(shape)
        idx = torch.arange(size, dtype=torch.int64, device=self.device).reshape(shape)
        if size > MASK32:
            return self._hash(idx & MASK32, idx >> 32)
        return self._hash(idx)

    def uniform(self, shape: Sequence[int], dtype=torch.float32, minval=0.0,
                maxval=1.0) -> torch.Tensor:
        """``jax.random.uniform(key, shape, dtype, minval, maxval)``, float32
        or float64, shape ``(*batch, *shape)``."""
        b1, b2 = self.bits(shape)
        if dtype == torch.float32:
            word = ((b1 ^ b2) >> 9) | _ONE_F32
            floats = word.to(torch.int32).view(torch.float32) - 1.0
            lo, span = np.float32(minval), np.float32(maxval) - np.float32(minval)
        elif dtype == torch.float64:
            word = (b1 << 20) | (b2 >> 12) | _ONE_F64
            floats = word.view(torch.float64) - 1.0
            lo, span = np.float64(minval), np.float64(maxval) - np.float64(minval)
        else:
            raise TypeError(f"uniform draws float32 or float64, not {dtype}")
        if span == 1.0 and lo == 0.0:
            return floats
        # the bounds rounded to the dtype first, as jax.random.uniform; XLA
        # contracts floats * span + lo into one fused multiply-add
        return torch.clamp(_fma(floats, float(span), float(lo)), min=float(lo))

    def randint(self, shape: Sequence[int], minval: int, maxval: int,
                bits: int = 64) -> torch.Tensor:
        """``jax.random.randint(key, shape, minval, maxval)`` (int64 under
        ``jax_enable_x64``, JAX's default int then; ``bits=32`` for its
        int32 draw): two ``bits``-bit draws from ``split()``'s two keys,
        ``(hi mod span) * (2**bits mod span) + lo mod span``, mod span, as
        JAX's ``_randint`` computes it in unsigned ``bits``-bit arithmetic
        (a span of 1 where ``maxval <= minval``).  Spans up to 2**31 - 1."""
        span = int(maxval) - int(minval) if maxval > minval else 1
        if span >= 1 << 31:
            raise ValueError(f"randint spans up to 2**31 - 1, not {span}")
        k_hi, k_lo = self.split()

        def mod_span(key):
            b1, b2 = key.bits(shape)
            if bits == 32:
                return (b1 ^ b2) % span
            # the 64-bit word (b1 << 32) | b2, reduced without leaving int64
            return ((b1 % span) * ((1 << 32) % span) + b2) % span

        half = (1 << (bits // 2)) % span
        multiplier = ((half * half) & ((1 << bits) - 1)) % span  # wraps as uint32 does
        offset = mod_span(k_hi) * multiplier
        if bits == 32:
            offset = (offset & MASK32) + mod_span(k_lo) & MASK32
        else:
            offset = offset + mod_span(k_lo)
        return int(minval) + offset % span


_SPLITTER = 134217729.0  # 2**27 + 1, Dekker's split of a float64


def _fma(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """a * b + c rounded once (a fused multiply-add), for float32 or float64
    ``a`` and dtype-exact scalars ``b``, ``c``.  Where the product is exact
    (c == 0, or b a power of two) the plain expression is already that;
    float32 otherwise rounds the float64 result (the product of two float32
    values is exact in float64); float64 adds the product's and the sum's
    rounding errors back (Dekker's two-product and Knuth's two-sum)."""
    m, _ = math.frexp(abs(b))
    if c == 0.0 or m == 0.5:
        return a * b + c
    if a.dtype == torch.float32:
        return (a.double() * b + c).float()
    p = a * b
    t = a * _SPLITTER
    a_hi = t - (t - a)
    a_lo = a - a_hi
    tb = b * _SPLITTER
    b_hi = tb - (tb - b)
    b_lo = b - b_hi
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    s = p + c
    bb = s - p
    s_err = (p - (s - bb)) + (c - bb)
    return s + (err + s_err)


def uniform_pos(key: Key, shape, dtype) -> torch.Tensor:
    """Uniform in (0, 1): floored at the dtype's tiny, like gsl_rng_uniform_pos
    (``mcrat_tpu.ops.rng.uniform_pos``)."""
    return torch.clamp(key.uniform(shape, dtype), min=torch.finfo(dtype).tiny)


def isotropic_direction(key: Key, shape, dtype) -> torch.Tensor:
    """Isotropic unit vectors (..., 3): cos(theta) uniform in [-1, 1], phi
    uniform (``mcrat_tpu.ops.rng.isotropic_direction``; reference:
    Src/mclib.c:225-233)."""
    k1, k2 = key.split()
    cos_t = k1.uniform(shape, dtype, -1.0, 1.0)
    phi = k2.uniform(shape, dtype, 0.0, 2.0 * math.pi)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def batched_rejection(key: Key, shape, propose: Callable[[Key], Tuple],
                      accept: Callable[..., torch.Tensor], init: Tuple,
                      max_iters: int = 24):
    """Rejection sampling over a batch with ``max_iters`` trials
    (``mcrat_tpu.ops.rng.batched_rejection``): trial ``i`` proposes from
    ``key.fold_in(i)``; each lane keeps its first accepted candidate, and a
    lane that accepts none keeps ``init``.

    JAX unrolls the trials into one fused loop; here every trial runs at
    once: ``propose`` gets the (max_iters,)-batch of trial keys and returns
    candidates of shape ``(max_iters, *shape, ...)``, ``accept`` maps them to
    a ``(max_iters, *shape)`` mask.  The lanes' results are those of the
    sequential loop.  Returns the tuple of accepted arrays."""
    cand = propose(key.fold_in_range(max_iters))
    ok = accept(*cand)
    taken = ok.any(dim=0)
    first = torch.argmax(ok.to(torch.uint8), dim=0)
    out = []
    for c, v in zip(cand, init):
        extra = c.dim() - 1 - first.dim()
        idx = first.reshape(first.shape + (1,) * extra).expand(c.shape[1:])
        pick = torch.gather(c, 0, idx[None])[0]
        mask = taken.reshape(taken.shape + (1,) * extra)
        out.append(torch.where(mask, pick, v))
    return tuple(out)
