"""The port's copy of JAX's random numbers (`train/prng.py`) against
`jax.random` on the CPU: keys, splits, fold_in, uniform and randint equal
bit for bit; normal equal in at least 98% of draws and within 4 ulps in
all (XLA's erfinv polynomial evaluated in PyTorch, whose log1p rounds
otherwise; measured: 99.1% equal, 3 ulps at most); choice with
probabilities equal at the sizes the fit tests use (a 131,072-slot
cumulative sum, summed in another order, moved 1-2 of 512 draws to a
neighbouring index when measured)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatter_a_video_tpu_torch.train import prng

SEEDS = [0, 1, 12345, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_are_jax_bits(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    assert np.array_equal(np.array(jk).astype(np.int64), tk.numpy())
    for num in (2, 3, 7):
        assert np.array_equal(np.array(jax.random.split(jk, num)).astype(np.int64), prng.split(tk, num).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_is_jax_bits(seed):
    for data in (0, 1, 2, 77, 2**31 - 1, 2**32 - 1):
        j = np.array(jax.random.fold_in(jax.random.PRNGKey(seed), data)).astype(np.int64)
        assert np.array_equal(j, prng.fold_in(prng.key(seed), data).numpy()), data
    jk, tk = subkeys(seed)
    assert np.array_equal(np.array(jax.random.fold_in(jk, 3)).astype(np.int64), prng.fold_in(tk, 3).numpy())


def subkeys(seed):
    return jax.random.split(jax.random.PRNGKey(seed))[1], prng.split(prng.key(seed))[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_randint_are_jax_bits(seed):
    jk, tk = subkeys(seed)
    assert np.array_equal(np.array(jax.random.uniform(jk, (1001,))), prng.uniform(tk, (1001,)).numpy())
    assert np.array_equal(np.array(jax.random.uniform(jk, (4, 5), minval=-2.0, maxval=3.0)),
                          prng.uniform(tk, (4, 5), -2.0, 3.0).numpy())
    for n in (1, 7, 1000, 131072):
        assert np.array_equal(np.array(jax.random.randint(jk, (300,), 0, n)),
                              prng.randint(tk, (300,), 0, n).numpy()), n


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_a_few_ulps(seed):
    jk, tk = subkeys(seed)
    j = np.array(jax.random.normal(jk, (3968, 3)))
    t = prng.normal(tk, (3968, 3)).numpy()
    ulp = np.spacing(np.abs(j).astype(np.float32))
    assert (np.abs(t - j) <= 4 * ulp).all()
    assert (t == j).mean() >= 0.98


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,alive", [(128, 46), (3968, 3000)])
def test_choice_draws_jax_indices(seed, n, alive):
    jk, tk = subkeys(seed)
    mask = np.arange(n) < alive
    p = mask.astype(np.float32) / mask.sum()
    j = np.array(jax.random.choice(jk, n, (512,), replace=True, p=jnp.asarray(p)))
    t = prng.choice(tk, n, (512,), torch.from_numpy(p))
    assert t.dtype == torch.int64 and np.array_equal(t.numpy(), j)
