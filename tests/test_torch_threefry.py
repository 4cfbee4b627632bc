"""The port's threefry randoms against jax.random, bit for bit.

The path tracer draws each ray's randoms as uniform(fold_in(fold_in(
fold_in(key(seed), bounce), g // total), g % total), (2,)) for its global
lane g; utils/threefry.py reproduces that draw in integer torch ops. Keys
and words must be equal, the uniforms equal as bit patterns. The cosine
direction built from them (render/pathtrace._cosine_dir) goes through
cos/sin, whose last bit differs between XLA's and PyTorch's CPU
libraries: it must agree within 2 ulp of 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtmm_tpu.render import pathtrace as jpt
from rtmm_tpu_torch.render import pathtrace
from rtmm_tpu_torch.utils import threefry

SEEDS = [0, 1, 42, 2**31 - 1]
LANES = np.array([0, 1, 2, 1535, 1536, 4097, 99991, 2**19 + 3, 2**20 - 1,
                  2**20], np.int32)


def _words(k):
    return [int(x) for x in k]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_words(seed):
    k = jax.random.key(seed)
    assert _words(threefry.key(seed)) == _words(
        np.asarray(jax.random.key_data(k)))
    for data in (0, 1, 3, 1536, 2**20):
        ref = np.asarray(jax.random.key_data(jax.random.fold_in(k, data)))
        assert _words(threefry.fold_in(threefry.key(seed), data)) == \
            _words(ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounce", [0, 1, 2])
def test_hash_uniforms_bit_equal(seed, bounce):
    total = 2048
    kb = jax.random.fold_in(jax.random.key(seed), bounce)
    ref = np.asarray(jax.vmap(lambda g: jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(kb, g // total), g % total),
        (2,)))(jnp.asarray(LANES)))
    got = pathtrace._rand2(threefry.key(seed), bounce,
                           torch.from_numpy(LANES), total).numpy()
    assert got.dtype == np.float32 and got.shape == (len(LANES), 2)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert (got >= 0.0).all() and (got < 1.0).all()


def test_cosine_dir_within_two_ulp():
    rng = np.random.default_rng(3)
    u = rng.uniform(size=(4096, 2)).astype(np.float32)
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:8] = [0.0, 0.0, 1.0]               # the other basis branch
    ref = np.asarray(jpt._cosine_dir(jnp.asarray(u), jnp.asarray(n)))
    got = pathtrace._cosine_dir(torch.from_numpy(u),
                                torch.from_numpy(n)).numpy()
    assert np.abs(got - ref).max() <= 2 * np.finfo(np.float32).eps
    # Unit directions in the normal's hemisphere.
    assert np.abs(np.linalg.norm(got, axis=-1) - 1.0).max() < 1e-5
    assert ((got * n).sum(-1) >= -1e-6).all()
