"""The port's random-graph generators and its binomial against the JAX
package, bit for bit on the CPU: ``prng.binomial`` against
``jax.random.binomial`` on a fixed sweep of (seed, count, p) — both
branches, p on both sides of 0.5, count 0, NaN and negative counts and
the generators' own (n, p); ``erdos_renyi`` (sparse and near-complete,
with ``max_degree`` and with ``connect_isolated``) and ``barabasi_albert``
(exact and chunked, m in {1, 2, 3}, phantom arrivals in the last block)
against the reference's neighbour tables and degrees; and the plain
attachment with too few pre-drawn rounds, which must draw the rest on
the host and still give the reference's graph."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import topology as R  # noqa: E402
from repro_torch import topology as T  # noqa: E402
from repro_torch.kernels.attach import ops as attach_ops  # noqa: E402
from repro_torch.kernels.attach import ref as attach_ref  # noqa: E402
from repro_torch.kernels.attach.ref import attach_plain  # noqa: E402
from repro_torch.topology.generators import attachment  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

CPU = "cpu"

#: the generators' (n, p): each ER build draws Binomial(n(n-1)/2, p)
GENERATOR_PAIRS = [(30, .15), (50, .1), (200, .008), (120, .04), (32, .2),
                   (1000, .01), (10**5, 4 / 10**5), (10**6, 4 / 10**6)]
#: (count, p) classes of the sweep: inversion (count·q <= 10) and BTRS,
#: p below and above 0.5, the edges
GRID = {
    "inversion_low_p": [(c, p) for c in (1, 5, 10, 40, 100)
                        for p in (0.001, 0.02, 0.1)],
    "inversion_high_p": [(c, p) for c in (1, 5, 10, 40, 100)
                         for p in (0.999, 0.98, 0.9)],
    "btrs_low_p": [(c, p) for c in (21, 100, 1000, 12345, 4e11)
                   for p in (0.05, 0.3, 0.4999)],
    "btrs_high_p": [(c, p) for c in (21, 100, 1000, 12345, 4e11)
                    for p in (0.5, 0.7, 0.95)],
    "edges": [(0, 0.3), (0, 0.7), (7, 0.0), (7, 1.0), (2.5, 0.4),
              (-3, 0.2), (float("nan"), 0.2), (30, float("nan")),
              (30, -0.1), (1e6, 0.5)],
}
SEEDS_PER_CASE = 4


def _binomial_pair(cases, seeds):
    """(port, reference) samples of every (seed, count, p)."""
    s = np.repeat(np.asarray(seeds, np.uint32), len(cases))
    c = np.tile(np.asarray([x[0] for x in cases], np.float64), len(seeds))
    p = np.tile(np.asarray([x[1] for x in cases], np.float64), len(seeds))
    ref = jax.vmap(lambda sd, n, q: jax.random.binomial(
        jax.random.key(sd), n, q))(jnp.asarray(s), jnp.asarray(c, jnp.float32),
                                   jnp.asarray(p, jnp.float32))
    keys = torch.stack([prng.key(int(x), device=CPU) for x in s])
    got = prng.binomial(keys, torch.tensor(c, dtype=torch.float32),
                        torch.tensor(p, dtype=torch.float32))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("n,p", GENERATOR_PAIRS)
def test_binomial_generator_counts(n, p):
    """The edge count of erdos_renyi at the generators' (n, p), 20
    seeds each: the count passes through float32."""
    got, want = _binomial_pair([(float(n * (n - 1) // 2), p)], range(20))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(GRID))
def test_binomial_sweep(kind):
    got, want = _binomial_pair(GRID[kind], range(SEEDS_PER_CASE))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)  # NaN equals NaN here


def test_binomial_sweep_size():
    cases = len(GENERATOR_PAIRS) * 20 + SEEDS_PER_CASE * sum(
        len(v) for v in GRID.values())
    assert cases >= 256


@pytest.mark.parametrize("seed,count,p", [(0, 1225.0, 0.1), (3, 30.0, 0.2),
                                          (5, 4e11, 0.7), (9, 0.0, 0.5)])
def test_binomial_scalar_key(seed, count, p):
    """One key, Python numbers: a 0-d sample equal to the reference's
    unbatched call."""
    got = prng.binomial(prng.key(seed, device=CPU), count, p)
    assert got.shape == () and got.dtype == torch.float32
    want = jax.random.binomial(jax.random.key(seed), count, p)
    assert float(got) == float(want)


def test_binomial_asserts_when_rounds_run_out(monkeypatch):
    """Too few rounds is an error, never a silent sample."""
    monkeypatch.setattr(prng, "BINOMIAL_ROUNDS", 2)
    with pytest.raises(RuntimeError, match="rounds"):
        prng.binomial(prng.key(1, device=CPU), 1000.0, 0.01)


def assert_same_topology(ref, port):
    np.testing.assert_array_equal(port.neighbors.numpy(),
                                  np.asarray(ref.neighbors))
    np.testing.assert_array_equal(port.degrees.numpy(),
                                  np.asarray(ref.degrees))
    assert port.neighbors.dtype == torch.int32
    assert port.degrees.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,p,max_degree", [
    (30, .15, None), (50, .1, None), (120, .04, None), (200, .008, None),
    (32, .2, 32), (12, 0.99, None)])
def test_erdos_renyi(n, p, max_degree, seed):
    """(12, 0.99) is the near-complete regime (every pair drawn)."""
    ref = R.erdos_renyi(n, p, jax.random.key(seed), max_degree=max_degree)
    port = T.erdos_renyi(n, p, prng.key(seed, device=CPU),
                         max_degree=max_degree, device=CPU)
    assert_same_topology(ref, port)


@pytest.mark.parametrize("seed", [4, 6])
def test_erdos_renyi_connect_isolated(seed):
    """At n = 200, p = .008 a fifth of the nodes are isolated."""
    ref = R.erdos_renyi(200, .008, jax.random.key(seed))
    port = T.erdos_renyi(200, .008, prng.key(seed, device=CPU), device=CPU)
    assert int((port.degrees == 0).sum()) > 0  # something to patch
    assert_same_topology(
        R.connect_isolated(ref, jax.random.key(seed + 1)),
        T.connect_isolated(port, prng.key(seed + 1, device=CPU)))


#: (n, m, chunk): every m, n and chunk of the sweep (each reference build
#: compiles anew, ~3 s, so not their product) and the frozen path at every
#: m; (30, 2, 16), (50, 3, 16) and (2000, 1, 64) end in a block of phantom
#: arrivals (n - m - 1 - C not a multiple of C)
BA_CASES = [(30, 1, None), (50, 2, None), (2000, 3, None), (30, 2, 16),
            (50, 3, 16), (2000, 1, 64), (50, 3, 1)]


@functools.lru_cache(maxsize=None)
def _reference_ba(n, m, chunk):
    return R.barabasi_albert(n, m, jax.random.key(7), chunk=chunk)


@pytest.mark.parametrize("n,m,chunk", BA_CASES)
def test_barabasi_albert(n, m, chunk):
    port = T.barabasi_albert(n, m, prng.key(7, device=CPU), chunk=chunk,
                             device=CPU)
    assert_same_topology(_reference_ba(n, m, chunk), port)


@pytest.mark.parametrize("n,m", [(30, 1), (30, 2), (30, 3), (50, 2)])
def test_barabasi_albert_chunk_one_is_exact(n, m):
    key = prng.key(3, device=CPU)
    exact = T.barabasi_albert(n, m, key, device=CPU)
    one = T.barabasi_albert(n, m, key, chunk=1, device=CPU)
    assert torch.equal(exact.neighbors, one.neighbors)
    assert torch.equal(exact.degrees, one.degrees)


@pytest.mark.parametrize("rounds", [0, 1])
@pytest.mark.parametrize("n,m,chunk", [(50, 2, None), (30, 2, 16),
                                       (50, 3, 1)])
def test_attach_plain_redraws(monkeypatch, n, m, chunk, rounds):
    """With fewer pre-drawn rounds than an arrival needs (0: none at
    all), the plain attachment draws the rest on the host, along the
    same key chain."""
    calls = []

    def few_rounds(*args, **kwargs):
        calls.append(kwargs["count"])
        return attach_plain(*args, rounds=rounds, **kwargs)

    monkeypatch.setattr(attach_ops, "attach_plain", few_rounds)
    port = T.barabasi_albert(n, m, prng.key(7, device=CPU), chunk=chunk,
                             device=CPU)
    assert sum(calls) >= n - m - 1
    assert_same_topology(_reference_ba(n, m, chunk), port)


def test_attach_plain_writes_the_slabs():
    """Serial arrivals append [targets, t × m] to the multiset; a frozen
    block draws only below its fill."""
    m, key = 2, prng.key(0, device=CPU)
    ends = torch.zeros(6 + 4 * 5, dtype=torch.int32)
    ends[:6] = torch.tensor([0, 0, 1, 1, 2, 2])
    out = attach_plain(key, ends, first=3, count=2, fill=6, m=m)
    assert ends[6:10].tolist() == out[0].tolist() + [3, 3]
    assert ends[10:14].tolist() == out[1].tolist() + [4, 4]
    assert all(len(set(r)) == m for r in out.tolist())
    frozen = attach_plain(key, ends, first=5, count=3, fill=14, m=m,
                          warm=0)
    assert set(frozen.reshape(-1).tolist()) <= set(ends[:14].tolist())
    assert ends[14:26].reshape(3, 4)[:, 2:].tolist() == [[5, 5], [6, 6],
                                                          [7, 7]]


def _attachment_by_calls(n, m, key, chunk, piece=37):
    """``attachment`` as calls of their own: the exact warm-up in pieces
    of ``piece`` arrivals, then each frozen block."""
    seed_sz, arrivals = m + 1, n - m - 1
    warm = arrivals if chunk is None else min(arrivals, chunk)
    c = 1 if chunk is None else chunk
    count = warm + -(-(arrivals - warm) // c) * c
    si, sj = torch.triu_indices(seed_sz, seed_sz, 1)
    fill = seed_sz * m
    ends = torch.zeros(fill + 2 * m * count, dtype=torch.int32)
    ends[:fill] = torch.cat([si, sj])
    calls = [(a, min(piece, warm - a), None) for a in range(0, warm, piece)]
    calls += [(a, c, 0) for a in range(warm, count, c)]
    tgts = [attach_plain(key, ends, first=seed_sz + a, count=k,
                         fill=fill + 2 * m * a, m=m, warm=w)
            for a, k, w in calls]
    return torch.cat(tgts), ends


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("n,chunk", [(60, None), (60, 1), (300, 16),
                                     (1100, 1024)])
def test_attach_one_call_equals_calls_per_block(n, m, chunk):
    """One call for a whole build (the exact warm-up, then frozen blocks,
    the last with phantom arrivals at n = 300 and 1100) equals the warm-up and
    each block as calls of their own: targets and the whole multiset."""
    key = prng.key(7, device=CPU)
    before = attach_ref.rounds_drawn
    tgts, ends = attachment(n, m, key, chunk=chunk)
    one = attach_ref.rounds_drawn - before
    want, want_ends = _attachment_by_calls(n, m, key, chunk)
    assert torch.equal(tgts, want)
    assert torch.equal(ends, want_ends)
    assert attach_ref.rounds_drawn - before == 2 * one
    assert tgts.shape[0] >= n - m - 1


def _first_slots(key, spans):
    """Each arrival's first-round slot (t = 2, 3, ...), drawn by hand:
    ``randint(split(fold_in(key, t))[1], (), 0, span)``."""
    return [int(prng.randint(prng.split(prng.fold_in(key, torch.tensor(
        2 + a)))[1], (), 0, span)) for a, span in enumerate(spans)]


@pytest.mark.parametrize("seed,warm,want", [(2, None, 2), (14, None, 1),
                                            (6, None, 0), (33, 1, 1)])
def test_attach_plain_chain_depth(seed, warm, want):
    """Three arrivals of m = 1 after the seed pair (fill 2): each keeps its
    first draw, so the slots say the chain. Slots 2 and 4 are arrival 0's
    and 1's targets (a link each), 3 and 5 their sources (none). Seed 2
    draws 1, 2, 4: arrival 2 reads arrival 1's target, which is arrival
    0's: two links. Seed 14 draws 0, 2, 3: one; seed 6 0, 1, 3: none.
    With warm 1 (then one frozen block of two) arrival 2 draws below slot
    4: seed 33 draws 1, 2, 2, both later arrivals read arrival 0's
    target: one link."""
    key = prng.key(seed, device=CPU)
    spans = [2, 4, 6] if warm is None else [2, 4, 4]
    slots = _first_slots(key, spans)
    ends = torch.zeros(8, dtype=torch.int32)
    ends[1] = 1
    out = attach_plain(key, ends, first=2, count=3, fill=2, m=1, warm=warm)
    assert attach_ref.chain_depth == want
    assert slots == {2: [1, 2, 4], 14: [0, 2, 3], 6: [0, 1, 3],
                     33: [1, 2, 2]}[seed]
    if seed in (2, 33):
        assert out[:, 0].tolist() == [1, 1, 1]   # each took arrival 0's
    assert ends[2:].tolist() == [v for a, r in enumerate(out.tolist())
                                 for v in (r[0], 2 + a)]


def test_attach_blocks_refused():
    key, ends = prng.key(0, device=CPU), torch.zeros(20, dtype=torch.int32)
    for warm, block in ((-1, None), (5, None), (0, 0)):
        with pytest.raises(ValueError):
            attach_plain(key, ends, first=3, count=4, fill=2, m=1,
                         warm=warm, block=block)


def test_generator_arguments_refused():
    key = prng.key(0, device=CPU)
    with pytest.raises(ValueError):
        T.barabasi_albert(3, 3, key, device=CPU)
    with pytest.raises(ValueError):
        T.barabasi_albert(10, 2, key, chunk=0, device=CPU)
    assert T.GENERATORS["erdos_renyi"] is T.erdos_renyi
    assert T.GENERATORS["barabasi_albert"] is T.barabasi_albert
