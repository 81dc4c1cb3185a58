"""PyTorch port vs JAX: the random streams of `utils/threefry.py`.

The port draws the VQ codebook's start and batches and the seeded LPIPS
network with the JAX package's `jax.random` streams. Held here against
`jax.random` itself (threefry, partitionable counters), on the CPU:
- `PRNGKey` and `split`: bit for bit;
- `random_bits`, `randint` (spans that are and are not powers of two, one
  that wraps JAX's uint32 multiplier, a negative minimum, an empty span)
  and `uniform`: bit for bit;
- `normal`: within 2 ulp (the erfinv, log1p and log of XLA rebuilt in torch;
  almost every value is bit-equal);
- the key chain and the batch indices of `train_codebook`'s loop, drawn a
  block at a time by the port, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu_torch.compress import vq as tvq
from lightgaussian_tpu_torch.utils import threefry as tf

torch.set_num_threads(1)

SEEDS = (0, 1, 7, 123456, 2**31 - 1)


def _key(seed):
    return jax.random.PRNGKey(seed)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_equal(seed):
    assert tf.prng_key(seed) == tuple(int(v) for v in np.asarray(_key(seed)))
    for num in (2, 3, 5):
        want = [tuple(map(int, k)) for k in np.asarray(jax.random.split(_key(seed), num))]
        assert tf.split(tf.prng_key(seed), num) == want
    with pytest.raises(ValueError):
        tf.prng_key(2**31)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_bit_equal(seed):
    want = np.asarray(jax.random.bits(_key(seed), (1000,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(tf.random_bits([tf.prng_key(seed)], 1000)[0].numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((1000,), 0, 300_000),  # not a power of two, above 2**16: the multiplier wraps to 0
    ((17, 3), 0, 1024),  # a power of two
    ((5000,), -7, 13),
    ((100,), 0, 2**31 - 1),
    ((64,), 0, 65_537),
    ((10,), 5, 5),  # an empty span gives the minimum
])
def test_randint_bit_equal(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(_key(seed), shape, lo, hi))
    got = tf.randint(tf.prng_key(seed), shape, lo, hi).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [((1000,), 0.0, 1.0), ((33, 7), -1.0, 1.0), ((99,), -3.5, 2.25)])
def test_uniform_bit_equal(seed, shape, lo, hi):
    want = np.asarray(jax.random.uniform(_key(seed), shape, jnp.float32, lo, hi))
    got = tf.uniform(tf.prng_key(seed), shape, lo, hi).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_two_ulp(seed):
    shape = (3, 3, 64, 128)
    want = np.asarray(jax.random.normal(_key(seed), shape, jnp.float32))
    got = tf.normal(tf.prng_key(seed), shape).numpy()
    ulps = _ulps(got, want)
    assert ulps.max() <= 2
    assert (ulps > 0).mean() < 1e-3  # the rebuilt functions round as XLA's almost everywhere


@pytest.mark.parametrize("seed,iterations,chunk,n", [(0, 50, 128, 300), (3, 7, 1000, 65_537)])
def test_codebook_loop_indices_bit_equal(seed, iterations, chunk, n):
    """The JAX fit's loop: key, sub = split(key); idx = randint(sub, (chunk,), 0, n)."""
    key = _key(seed)
    want = []
    for _ in range(iterations):
        key, sub = jax.random.split(key)
        want.append(np.asarray(jax.random.randint(sub, (chunk,), 0, n)))
    subs = tvq.sample_keys(tf.prng_key(seed), iterations)
    got = torch.cat([tf.randint_rows(subs[i:i + 3], chunk, 0, n) for i in range(0, iterations, 3)])
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
