"""The port's topology (repro_torch.topology) against the reference,
exactly: from_edges on messy edge sets, the deterministic generators,
Watts-Strogatz and connect_isolated from the same key, and the Topology
queries (gather, neighbor_fraction, sample_neighbor, edge_list)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import topology as R  # noqa: E402
from repro_torch import topology as T  # noqa: E402
from repro_torch.bridge import topology_from_numpy  # noqa: E402
from repro_torch.utils import prng  # noqa: E402


def assert_same_topology(ref, port):
    np.testing.assert_array_equal(port.neighbors.numpy(),
                                  np.asarray(ref.neighbors))
    np.testing.assert_array_equal(port.degrees.numpy(),
                                  np.asarray(ref.degrees))
    assert port.neighbors.dtype == torch.int32
    assert port.degrees.dtype == torch.int32


def _messy_edges(seed, n, e):
    """Duplicates (both directions), self loops, out-of-range and
    negative endpoints, and a validity mask."""
    rng = np.random.RandomState(seed)
    edges = rng.randint(-2, n + 2, size=(e, 2)).astype(np.int32)
    edges[: e // 4] = edges[e // 4: 2 * (e // 4), ::-1]  # reversed dups
    edges[-3:, 1] = edges[-3:, 0]                          # self loops
    valid = rng.rand(e) < 0.85
    return edges, valid


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_degree", [None, 2])
@pytest.mark.parametrize("symmetrize,self_loops", [(True, False),
                                                   (True, True),
                                                   (False, False)])
def test_from_edges_matches_reference(seed, max_degree, symmetrize,
                                      self_loops):
    n = 40  # one shape for every seed: the reference compiles once
    edges, valid = _messy_edges(seed, n, 4 * n)
    kw = dict(max_degree=max_degree, symmetrize=symmetrize,
              allow_self_loops=self_loops)
    ref = R.from_edges(n, jnp.asarray(edges), valid=jnp.asarray(valid), **kw)
    port = T.from_edges(n, torch.as_tensor(edges),
                        valid=torch.as_tensor(valid), device="cpu", **kw)
    assert_same_topology(ref, port)


@pytest.mark.parametrize("n,k", [(8, 2), (20, 6), (101, 10)])
def test_ring(n, k):
    assert_same_topology(R.ring(n, k), T.ring(n, k, device="cpu"))


@pytest.mark.parametrize("shape", [(5, 7), (2, 3)])
@pytest.mark.parametrize("neighborhood", ["von_neumann", "moore"])
@pytest.mark.parametrize("periodic", [True, False])
def test_lattice2d(shape, neighborhood, periodic):
    ref = R.lattice2d(*shape, neighborhood=neighborhood, periodic=periodic)
    port = T.lattice2d(*shape, neighborhood=neighborhood,
                       periodic=periodic, device="cpu")
    assert_same_topology(ref, port)


# n = 256, k = 4 throughout the file, so the reference compiles once
@pytest.mark.parametrize("n,k,beta,seed", [(256, 4, 0.2, 0), (256, 4, 1.0, 1),
                                           (1000, 10, 0.1, 2)])
def test_watts_strogatz(n, k, beta, seed):
    ref = R.watts_strogatz(n, k, beta, jax.random.key(seed))
    port = T.watts_strogatz(n, k, beta, prng.key(seed, device="cpu"),
                            device="cpu")
    assert_same_topology(ref, port)


@pytest.mark.parametrize("seed", range(2))
def test_connect_isolated(seed):
    """A sparse random graph leaves isolated nodes to patch."""
    edges = np.random.RandomState(seed).randint(0, 256, (80, 2))
    ref = R.from_edges(256, jnp.asarray(edges, jnp.int32), max_degree=4)
    port = T.from_edges(256, torch.as_tensor(edges), max_degree=4,
                        device="cpu")
    assert int((port.degrees == 0).sum()) > 0
    assert_same_topology(R.connect_isolated(ref, jax.random.key(7)),
                         T.connect_isolated(port, prng.key(7, device="cpu")))


def test_edge_list_round_trip():
    ref = R.watts_strogatz(256, 4, 0.3, jax.random.key(5))
    port = topology_from_numpy(np.asarray(ref.neighbors),
                               np.asarray(ref.degrees), device="cpu")
    edges, valid = port.edge_list()
    r_edges, r_valid = ref.edge_list()
    np.testing.assert_array_equal(edges.numpy(), np.asarray(r_edges))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))
    assert_same_topology(ref, T.from_edges(port.n_nodes, edges, valid=valid,
                                           device="cpu"))


@pytest.fixture(scope="module")
def graphs():
    ref = R.watts_strogatz(256, 4, 0.5, jax.random.key(3))
    return ref, topology_from_numpy(np.asarray(ref.neighbors),
                                    np.asarray(ref.degrees), device="cpu")


def test_gather_and_neighbor_fraction(graphs):
    ref, port = graphs
    rng = np.random.RandomState(0)
    values = rng.randint(0, 5, ref.n_nodes).astype(np.int32)
    rows = rng.randint(0, ref.n_nodes, (4, 9)).astype(np.int32)
    g_ref, m_ref = ref.gather(jnp.asarray(values), jnp.asarray(rows), fill=-3)
    g, m = port.gather(torch.as_tensor(values), torch.as_tensor(rows),
                       fill=-3)
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    ind = values > 2
    f_ref = ref.neighbor_fraction(jnp.asarray(ind), jnp.asarray(rows))
    f = port.neighbor_fraction(torch.as_tensor(ind), torch.as_tensor(rows))
    assert f.dtype == torch.float32
    np.testing.assert_array_equal(f.numpy().view(np.uint32),
                                  np.asarray(f_ref).view(np.uint32))


def test_sample_neighbor(graphs):
    ref, port = graphs
    v = np.arange(ref.n_nodes, dtype=np.int32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(9), i))(
        jnp.asarray(v))
    want = np.asarray(jax.vmap(ref.sample_neighbor)(jkeys, jnp.asarray(v)))
    tkeys = prng.fold_in(prng.key(9, device="cpu"), torch.as_tensor(v))
    got = port.sample_neighbor(tkeys, torch.as_tensor(v))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).all()


# ------------------------------------------------ block graph, dense helpers
@pytest.mark.parametrize("block", [1, 4, 8, 32])
def test_block_graph(graphs, block):
    """Block adjacency with self loops, through the sparse from_edges."""
    ref, port = graphs
    assert_same_topology(ref.block_graph(block), port.block_graph(block))
    with pytest.raises(ValueError, match="divide"):
        port.block_graph(7)


def test_block_graph_of_ring():
    """The SIRS ring: blocks of 50 on a degree-14 ring see one block on
    each side."""
    ref, port = R.ring(1000, 14), T.ring(1000, 14, device="cpu")
    got = port.block_graph(50)
    assert_same_topology(ref.block_graph(50), got)
    assert got.max_degree == 3


def test_n_edges_and_neighbor_mask(graphs):
    ref, port = graphs
    for r, p in ((ref, port), (ref.block_graph(8), port.block_graph(8))):
        assert int(p.n_edges) == int(r.n_edges)
        np.testing.assert_array_equal(p.neighbor_mask().numpy(),
                                      np.asarray(r.neighbor_mask()))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("max_degree,self_loops", [(None, False), (3, False),
                                                   (None, True)])
def test_adjacency_round_trip(seed, max_degree, self_loops):
    rng = np.random.RandomState(seed)
    adj = rng.rand(30, 30) < 0.15
    ref = R.from_adjacency(jnp.asarray(adj), max_degree=max_degree,
                           allow_self_loops=self_loops)
    port = T.from_adjacency(torch.as_tensor(adj), max_degree=max_degree,
                            allow_self_loops=self_loops, device="cpu")
    assert_same_topology(ref, port)
    np.testing.assert_array_equal(port.adjacency().numpy(),
                                  np.asarray(ref.adjacency()))


@pytest.mark.parametrize("n", [2, 9, 40])
def test_complete(n):
    assert_same_topology(R.complete(n), T.complete(n, device="cpu"))


def test_dense_helpers_refuse_large_n():
    n = T.DENSE_LIMIT + 1
    with pytest.raises(ValueError, match="dense"):
        T.complete(n, device="cpu")
    big = T.ring(n, 2, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        big.adjacency()
