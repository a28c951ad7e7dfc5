"""The port's PRNG (repro_torch.utils.prng) against jax.random, bit for
bit: key, fold_in, split, randint (scalar, shaped and per-row bounds,
empty spans, spans above 2^16) and uniform."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.utils import prng  # noqa: E402

SEEDS = [0, 1, 42, 123456789, 2**31 - 1]
INDICES = [0, 1, 7, 65535, 65536, 99999, 2**31 - 1]


def _data(k):
    return np.asarray(jax.random.key_data(k))


def _pair(seed):
    return jax.random.key(seed), prng.key(seed, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in(seed):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(tk.numpy(), _data(jk))
    for i in INDICES:
        np.testing.assert_array_equal(prng.fold_in(tk, i).numpy(),
                                      _data(jax.random.fold_in(jk, i)))
    # a tensor of indices folds elementwise, as the engines use it
    idx = np.asarray(INDICES, np.int64)
    want = np.stack([_data(jax.random.fold_in(jk, int(i))) for i in idx])
    np.testing.assert_array_equal(
        prng.fold_in(tk, torch.as_tensor(idx)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 8])
def test_split(seed, num):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                  _data(jax.random.split(jk, num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [
    ((), 0, 10),
    ((17,), 0, 1_000_000),            # a node draw at realistic n
    ((3, 5), -7, 9),
    ((64,), 0, 2**16 + 3),            # span above 2^16
    ((64,), -(2**30), 2**30),         # span 2^31
    ((9,), 2**31 - 5, 2**31 - 1),     # near the int32 top
    ((9,), 5, 5),                     # maxval == minval -> minval
    ((9,), 8, 3),                     # maxval < minval  -> minval
])
def test_randint_scalar_bounds(seed, shape, lo, hi):
    jk, tk = _pair(seed)
    want = np.asarray(jax.random.randint(jk, shape, lo, hi))
    got = prng.randint(tk, shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_shaped_bounds(seed):
    jk, tk = _pair(seed)
    lo = np.array([0, -3, 5, 10, 0, 2**20], np.int32)
    hi = np.array([1, 3, 5, 2**17, 2, 2**20 + 1000], np.int32)
    want = np.asarray(jax.random.randint(jk, (4, 6), lo, hi))
    got = prng.randint(tk, (4, 6), torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_per_row_bound(seed):
    """One key per row and a per-row bound, as Topology.sample_neighbor
    draws under vmap in the reference."""
    jk, tk = _pair(seed)
    idx = jnp.arange(40)
    bound = np.arange(40, dtype=np.int32) % 11  # includes bound 0 -> span 1
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jk, i))(idx)
    want = np.asarray(jax.vmap(
        lambda k, m: jax.random.randint(k, (), 0, m))(jkeys, bound))
    tkeys = prng.fold_in(tk, torch.arange(40))
    got = prng.randint(tkeys, (), 0, torch.as_tensor(bound))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (5,), (3, 7), (1000,)])
def test_uniform(seed, shape):
    jk, tk = _pair(seed)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = prng.uniform(tk, shape)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_per_key(seed):
    """A batch of keys, one scalar draw each — SIS's execution draws."""
    jk, tk = _pair(seed)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.arange(33))
    want = np.asarray(jax.vmap(jax.random.uniform)(jkeys))
    got = prng.uniform(prng.fold_in(tk, torch.arange(33)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
