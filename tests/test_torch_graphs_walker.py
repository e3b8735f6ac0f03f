"""The port's graph packing, counter hash and walker against the JAX package.

Both packages get the same numpy inputs. Tables, hashes and walks are
integer or exact-IEEE float arithmetic in the same order, so they must be
bit-identical (except the dense-input Laplacian, see below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphgp_tpu import graphs as jgraphs
from graphgp_tpu import walker as jwalker
from graphgp_tpu.data.synthetic import generate_grid_data
from graphgp_tpu_torch import graphs as tgraphs
from graphgp_tpu_torch import walker as twalker
from graphgp_tpu_torch.devices import resolve_device


def _tables(g):
    return [np.asarray(x) for x in (g.neighbors, g.weights, g.degree)]


def _assert_tables_equal(gj, gt):
    for a, b in zip(_tables(gj), [x.numpy() for x in (gt.neighbors, gt.weights, gt.degree)]):
        np.testing.assert_array_equal(a, b)
    assert gt.num_nodes == gj.num_nodes and gt.max_degree == gj.max_degree


def _grid_adj():
    return generate_grid_data(400, seed=0)["adjacency"]


@pytest.mark.parametrize("name", ["ring", "er_csr", "grid"])
def test_pack_laplacian_tables_equal(name, ring_adj, er_adj):
    # Sparse inputs take numpy float64 in both packages: bit-identical. The
    # ring (degree 2) is exact through the dense float32 path too.
    adj = {"ring": ring_adj, "er_csr": sp.csr_matrix(er_adj), "grid": _grid_adj()}[name]
    _assert_tables_equal(jgraphs.pack_laplacian(adj), tgraphs.pack_laplacian(adj))


def test_pack_laplacian_dense_er_within_two_ulps(er_adj):
    # XLA's CPU float32 rsqrt is not correctly rounded (torch's is): each
    # weight is a product of two rsqrt factors, so it may differ by up to two
    # ulps (2 * 2**-23 relative); the structure is exact.
    gj, gt = jgraphs.pack_laplacian(er_adj), tgraphs.pack_laplacian(er_adj)
    nj, wj, dj = _tables(gj)
    np.testing.assert_array_equal(nj, gt.neighbors.numpy())
    np.testing.assert_array_equal(dj, gt.degree.numpy())
    np.testing.assert_allclose(gt.weights.numpy(), wj, rtol=2.4e-7, atol=0)


def test_hash_words_equal_on_random_u32():
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32) for _ in range(3))
    ref = np.asarray(jwalker._hash_words(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    out = twalker.hash_words(*(torch.from_numpy(x.astype(np.int64)) for x in (a, b, c)))
    np.testing.assert_array_equal(ref.astype(np.int64), out.numpy())
    bits = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(jwalker._uniform_01(jnp.asarray(bits))),
        twalker.uniform_01(torch.from_numpy(bits.astype(np.int64))).numpy(),
    )


def test_key_words_match_prngkey():
    for seed in (0, 7, 2**31 - 1):
        words = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).reshape(-1)
        assert (int(words[0]), int(words[-1])) == twalker.key_words(seed)


@pytest.mark.parametrize(
    "name,ablation,offset,count",
    [
        ("ring", False, 0, None),
        ("er_csr", False, 0, None),
        ("grid", False, 0, None),
        ("grid", False, 137, 64),
        ("er_csr", True, 0, None),
        ("grid", True, 50, 100),
    ],
)
def test_walk_log_bit_identical(name, ablation, offset, count, ring_adj, er_adj):
    adj = {"ring": ring_adj, "er_csr": sp.csr_matrix(er_adj), "grid": _grid_adj()}[name]
    cfg = dict(walks_per_node=24, p_halt=0.15, max_walk_length=5, ablation=ablation)
    ref = jwalker.sample_walk_log(
        jgraphs.pack_laplacian(adj), jax.random.PRNGKey(11), jwalker.WalkConfig(**cfg),
        node_offset=offset, num_start_nodes=count,
    )
    out = twalker.sample_walk_log(
        tgraphs.pack_laplacian(adj), 11, twalker.WalkConfig(**cfg),
        node_offset=offset, num_start_nodes=count,
    )
    np.testing.assert_array_equal(np.asarray(ref.curs), out.curs.numpy())
    np.testing.assert_array_equal(np.asarray(ref.loads), out.loads.numpy())


def test_zero_length_walk():
    g = tgraphs.pack_laplacian(_grid_adj())
    log = twalker.sample_walk_log(g, 0, twalker.WalkConfig(8, 0.1, 0))
    assert log.curs.shape == (0, 400, 8) and log.loads.shape == (0, 400, 8)


def test_resolve_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
