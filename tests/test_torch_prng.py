"""The port's threefry keys (``mcrat_tpu_torch.ops.prng``) against
``jax.random`` with ``impl="threefry2x32"`` (partitionable, JAX's default).

Bit for bit, over several seeds and shapes: key construction, ``split``,
``fold_in`` (and ``fold_in_range``), float32 and float64 ``uniform`` with
and without bounds, ``uniform_pos`` and ``batched_rejection``.
``isotropic_direction`` draws the same uniforms bit for bit; its sin and cos
come from two libraries (XLA's and PyTorch's), so its vectors agree within
two units in the last place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcrat_tpu.ops import rng as jrng
from mcrat_tpu_torch.ops import prng

SEEDS = [0, 1234, 987654321, 2**40 + 7]
SHAPES = [(7,), (3, 5), (1001, 2), (4, 3, 5)]
DTYPES = [(torch.float32, jnp.float32), (torch.float64, jnp.float64)]
# (0, 1), the samplers' bounds, and bounds where XLA's fused multiply-add
# rounds differently from a separate multiply and add
BOUNDS = [(0.0, 1.0), (-1.0, 1.0), (0.0, 2.0 * np.pi), (0.3, 7.1), (-2.5e3, 1e-3)]


def _jkey(seed):
    return jax.random.key(seed, impl="threefry2x32")


def _words(jkey):
    return np.asarray(jax.random.key_data(jkey))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_bit_equal(seed):
    k, jk = prng.Key.from_seed(seed), _jkey(seed)
    np.testing.assert_array_equal(k.state(), _words(jk))
    for n in (2, 3, 4):
        for got, want in zip(k.split(n), jax.random.split(jk, n)):
            np.testing.assert_array_equal(got.state(), _words(want))
    for i in (0, 1, 7, 2**31 + 5):
        np.testing.assert_array_equal(k.fold_in(i).state(), _words(jax.random.fold_in(jk, i)))
    many = k.fold_in_range(6)
    assert many.batch == (6,)
    for i in range(6):
        np.testing.assert_array_equal(many.data[i].numpy().astype(np.uint32),
                                      _words(jax.random.fold_in(jk, i)))
    # a chain of splits, as the engine walks its key
    for _ in range(3):
        k, _sub = k.split()
        jk, _jsub = jax.random.split(jk)
    np.testing.assert_array_equal(_sub.state(), _words(_jsub))
    # state round trip (the checkpoint field)
    np.testing.assert_array_equal(prng.Key.from_state(k.state()).state(), k.state())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_uniform_bit_equal(seed, dt):
    tdt, jdt = dt
    k, jk = prng.Key.from_seed(seed), _jkey(seed)
    for shape in SHAPES:
        for lo, hi in BOUNDS:
            got = k.uniform(shape, tdt, lo, hi).numpy()
            want = np.asarray(jax.random.uniform(jk, shape, jdt, lo, hi))
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{shape} [{lo}, {hi})")
        np.testing.assert_array_equal(prng.uniform_pos(k, shape, tdt).numpy(),
                                      np.asarray(jrng.uniform_pos(jk, shape, jdt)))
        got = prng.isotropic_direction(k, shape, tdt).numpy()
        want = np.asarray(jrng.isotropic_direction(jk, shape, jdt))
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.finfo(want.dtype).eps)


def test_batched_key_draws_what_each_key_draws():
    k = prng.Key.from_seed(5)
    keys = k.fold_in_range(4)
    both = keys.uniform((9, 2), torch.float64, -1.0, 1.0)
    for i in range(4):
        np.testing.assert_array_equal(both[i].numpy(),
                                      k.fold_in(i).uniform((9, 2), torch.float64, -1.0, 1.0))


@pytest.mark.parametrize("seed", [3, 11, 2024])
@pytest.mark.parametrize("dt", DTYPES, ids=["float32", "float64"])
def test_batched_rejection_bit_equal(seed, dt):
    """A two-draw proposal with a lane-dependent acceptance, so that lanes
    accept at different trials and some never (they keep ``init``)."""
    tdt, jdt = dt
    n = 3000
    thresh = np.linspace(0.02, 0.9, n)
    k, jk = prng.Key.from_seed(seed), _jkey(seed)
    t_thresh = torch.as_tensor(thresh, dtype=tdt)
    j_thresh = jnp.asarray(thresh, dtype=jdt)

    def t_propose(key):
        k1, k2 = key.split()
        return (k1.uniform((n,), tdt, -1.0, 1.0), k2.uniform((n, 2), tdt))

    def j_propose(key):
        k1, k2 = jax.random.split(key)
        return (jax.random.uniform(k1, (n,), jdt, -1.0, 1.0),
                jax.random.uniform(k2, (n, 2), jdt))

    got = prng.batched_rejection(
        k, (n,), t_propose, lambda c, y: (y[..., 0] * y[..., 1] < t_thresh) & (c > -0.8),
        init=(torch.zeros(n, dtype=tdt), torch.ones((n, 2), dtype=tdt)), max_iters=5)
    want = jrng.batched_rejection(
        jk, (n,), j_propose, lambda c, y: (y[..., 0] * y[..., 1] < j_thresh) & (c > -0.8),
        init=(jnp.zeros(n, jdt), jnp.ones((n, 2), jdt)), max_iters=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kept = (got[1] == 1.0).all(dim=1)
    assert 0 < int(kept.sum()) < n // 2  # some lanes never accepted


def test_uniform_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or float64"):
        prng.Key.from_seed(0).uniform((3,), torch.float16)
