"""``repro_torch.core.threefry`` against ``jax.random`` (jax 0.9.0's
default threefry2x32 with ``jax_threefry_partitionable = True``, x64 on as
the JAX package sets it): keys, ``split``, 32-bit bits, ``uniform``,
``normal`` and ``permutation`` / ``choice(replace=False)``, every case bit
for bit (tolerance 0 ulp).  ``normal`` runs through the port's copy of
XLA's f32 ``erf_inv``, ``log1p`` and ``log``, fused multiply-adds where
XLA's CPU code has them; they are also held bit for bit on a million f32
inputs each."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro  # noqa: F401  (x64, as the baselines run)

from repro_torch.core import threefry

from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

SEEDS = (0, 1, 7, 2**33 + 5)


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _bits(a) -> np.ndarray:
    """An f32 array's bit patterns, for a comparison at 0 ulp."""
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_split(seed):
    jk, tk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    assert np.array_equal(_words(jk), tk.numpy())
    for num in (2, 4):
        assert np.array_equal(_words(jax.random.split(jk, num)),
                              threefry.split(tk, num).numpy())
    # a chain of splits, as the baselines draw their rounds
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        tk, tsub = threefry.split(tk)
        assert np.array_equal(_words(jsub), tsub.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (3, 5), (1000,)])
def test_random_bits(seed, shape):
    want = jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)
    got = threefry.random_bits(threefry.prng_key(seed), shape)
    assert got.shape == shape
    assert np.array_equal(_words(want), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed):
    jk, tk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    for shape, bounds in (((1000,), ()), ((3, 5), ()),
                          ((1000,), (-3.5, 7.25)), ((64,), (2.0, 2.5))):
        want = jax.random.uniform(jk, shape, jnp.float32, *bounds)
        got = threefry.uniform(tk, shape, *bounds)
        assert got.dtype == torch.float32
        assert np.array_equal(_bits(want), _bits(got.numpy())), bounds


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(2, 3), (8, 3), (4096,)])
def test_normal(seed, shape):
    want = jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)
    got = threefry.normal(threefry.prng_key(seed), shape)
    assert np.array_equal(_bits(want), _bits(got.numpy()))


def test_normal_many_draws():
    """200,000 draws: both branches of erf_inv (w < 5 and w >= 5) and
    both of log1p, at 0 ulp."""
    for seed in (0, 3):
        want = jax.random.normal(jax.random.PRNGKey(seed), (200_000,),
                                 jnp.float32)
        got = threefry.normal(threefry.prng_key(seed), (200_000,))
        assert np.array_equal(_bits(want), _bits(got.numpy()))


def test_xla_math_bit_for_bit():
    """XLA's f32 log1p on (-1, 0] and erf_inv on (-1, 1), a million
    inputs each, at 0 ulp."""
    rng = np.random.default_rng(0)
    x = -rng.uniform(0, 1, 10**6).astype(np.float32)
    want = jax.jit(jnp.log1p)(x)
    assert np.array_equal(_bits(want),
                          _bits(threefry.log1p(torch.from_numpy(x))))
    u = rng.uniform(-1, 1, 10**6).astype(np.float32)
    u[:3] = (0.0, -1e-30, np.nextafter(np.float32(1), np.float32(0)))
    want = jax.jit(jax.lax.erf_inv)(u)
    assert np.array_equal(_bits(want),
                          _bits(threefry.erf_inv(torch.from_numpy(u))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, 1625, 1626, 100_000])
def test_permutation_and_choice(seed, n):
    """One sort round up to n = 1625, two from 1626 on."""
    jk, tk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    assert np.array_equal(np.asarray(jax.random.permutation(jk, n)),
                          threefry.permutation(tk, n).numpy())
    k = min(n, 32)
    want = jax.random.choice(jk, n, (k,), replace=False)
    assert np.array_equal(np.asarray(want),
                          threefry.choice(tk, n, (k,)).numpy())


def test_draws_keep_the_keys_device_and_refuse_oversampling():
    key = threefry.prng_key(5, device="cpu")
    assert key.device.type == "cpu" and key.dtype == torch.int64
    assert threefry.normal(key, (4,)).device.type == "cpu"
    with pytest.raises(ValueError):
        threefry.choice(key, 3, (4,))
