"""The port's random streams (utils/prng) against jax.random on the same
seeds: keys, split, fold_in, random bits and permutations bit for bit,
uniform floats bit for bit, Gumbel noise within 1e-6 (torch's log and
XLA's may differ in the last bit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yunikorn_tpu_torch.utils import prng

SEEDS = [0, 7, 123456, 2**31 - 1]


def words(key):
    """A JAX raw key (uint32 [..., 2]) as the port's int64 words."""
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in_are_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed, "cpu")
    np.testing.assert_array_equal(words(jk), tk.numpy())
    for num in (2, 3, 16):
        np.testing.assert_array_equal(words(jax.random.split(jk, num)),
                                      prng.split(tk, num).numpy())
    for data in (0, 1, 5, 2**31 + 3):
        np.testing.assert_array_equal(words(jax.random.fold_in(jk, data)),
                                      prng.fold_in(tk, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_are_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed, "cpu")
    for shape in ((1,), (37, 53), (3, 8, 17)):
        np.testing.assert_array_equal(
            words(jax.random.bits(jk, shape, jnp.uint32)),
            prng.random_bits(tk, shape).numpy())
    want = np.asarray(jax.random.uniform(jk, (64, 100)))
    got = prng.uniform(tk, (64, 100)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    tiny = float(np.finfo(np.float32).tiny)
    want = np.asarray(jax.random.uniform(jk, (300,), minval=tiny,
                                         maxval=1.0))
    got = prng.uniform(tk, (300,), tiny, 1.0).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_a_ulp_of_the_log(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed, "cpu")
    want = np.asarray(jax.random.gumbel(jk, (256, 300)))
    got = prng.gumbel(tk, (256, 300)).numpy()
    assert np.abs(want - got).max() <= 1e-6


@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_is_exact(seed):
    """Two shuffle rounds at 65,536 (the core's padded pod count), one
    below."""
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed, "cpu")
    for n in (1, 10, 1000, 65536):
        np.testing.assert_array_equal(np.asarray(jax.random.permutation(jk, n)),
                                      prng.permutation(tk, n).numpy())


def test_batched_keys_draw_each_key_stream():
    """A key batch [K, 2] draws K independent streams, each the stream of
    its own key (the pack arm's per-part noise)."""
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    tkeys = torch.from_numpy(words(keys))
    folded = prng.fold_in(tkeys, 3)
    bits = prng.random_bits(folded, (5, 7)).numpy()
    noise = prng.gumbel(folded, (5, 7)).numpy()
    for k in range(4):
        jf = jax.random.fold_in(keys[k], 3)
        np.testing.assert_array_equal(words(jf), folded[k].numpy())
        np.testing.assert_array_equal(
            words(jax.random.bits(jf, (5, 7), jnp.uint32)), bits[k])
        assert np.abs(np.asarray(jax.random.gumbel(jf, (5, 7)))
                      - noise[k]).max() <= 1e-6
