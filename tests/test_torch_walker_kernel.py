"""K4's plain PyTorch version (``cuda_kernels/walker.py``) against the JAX
package: the Pallas walk kernel in interpret mode, as
``tests/test_pallas_walker.py`` runs it, and the XLA gather walker; and the
Python around the CUDA kernel that a CPU can reach (the shared-memory plan,
the block size, the wrapper's refusals).

Tolerances: every walker draws the same walks bit for bit, so results differ
only in the order of the float32 additions. Against the gather walker that is
the order of one scatter-add (1e-6, relative for the large loads of late
steps, absolute for the rest). The Pallas kernel also splits each
load into three bf16-exact terms (~2^-21 relative) and scales by 1/W after
the sum: rtol 1e-4, atol 1e-5, the tolerance its own test holds it to.
"""
import jax
import numpy as np
import pytest
import torch

from graphgp_tpu import WalkConfig as JWalkConfig
from graphgp_tpu import pack_dense as jpack_dense
from graphgp_tpu import pack_laplacian as jpack_laplacian
from graphgp_tpu import walker as jwalker
from graphgp_tpu.pallas_kernels import sample_dense_step_matrices_pallas
from graphgp_tpu_torch import walker as twalker
from graphgp_tpu_torch.cuda_kernels import walker as k4
from graphgp_tpu_torch.graphs import PackedGraph, pack_dense, pack_laplacian


def _mesh_graph(side):
    n = side * side
    adj = np.zeros((n, n), np.float32)
    for r in range(side):
        for c in range(side):
            i = r * side + c
            if r + 1 < side:
                adj[i, i + side] = adj[i + side, i] = 1
            if c + 1 < side:
                adj[i, i + 1] = adj[i + 1, i] = 1
    return adj


def _sparse(adj):
    # sparse inputs pack bit-identically in both packages (numpy float64)
    import scipy.sparse as sp

    return sp.csr_matrix(adj)


@pytest.mark.parametrize("ablation", [False, True])
def test_plain_matches_pallas_interpret(ablation):
    adj = _sparse(_mesh_graph(8))
    kw = dict(walks_per_node=32, p_halt=0.1, max_walk_length=5, ablation=ablation)
    want = np.asarray(sample_dense_step_matrices_pallas(
        jpack_laplacian(adj), jax.random.PRNGKey(3), JWalkConfig(**kw),
        node_block=8, walk_block=8, interpret=True))
    got = k4.sample_dense_step_matrices_plain(pack_laplacian(adj), 3, twalker.WalkConfig(**kw))
    assert got.shape == (5, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # W = 32 is a power of two: 32 adds of 1/32 are exact
    np.testing.assert_array_equal(got[0].numpy(), np.eye(64, dtype=np.float32))


def test_plain_matches_pallas_interpret_odd_walks_per_node():
    """walks_per_node = 50 (the quickstart's) has no wide power-of-two factor;
    the Pallas wrapper shrinks its walk block, the port has no such rule."""
    adj = _sparse(_mesh_graph(4))
    kw = dict(walks_per_node=50, p_halt=0.1, max_walk_length=3)
    want = np.asarray(sample_dense_step_matrices_pallas(
        jpack_laplacian(adj), jax.random.PRNGKey(0), JWalkConfig(**kw), interpret=True))
    got = k4.sample_dense_step_matrices_plain(pack_laplacian(adj), 0, twalker.WalkConfig(**kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.eye(16), atol=1e-6)


@pytest.mark.parametrize("ablation", [False, True])
@pytest.mark.parametrize("wpn", [1, 7, 50])
def test_plain_matches_jax_gather_walker(wpn, ablation):
    adj = _sparse(_mesh_graph(6))
    kw = dict(walks_per_node=wpn, p_halt=0.1, max_walk_length=6, ablation=ablation)
    want = np.asarray(jwalker.sample_dense_step_matrices(
        jpack_laplacian(adj), jax.random.PRNGKey(11), JWalkConfig(**kw)))
    got = k4.sample_dense_step_matrices_plain(pack_laplacian(adj), 11, twalker.WalkConfig(**kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.eye(36), atol=1e-6)


@pytest.mark.parametrize("budget", [1, 40_000])
def test_plain_blocked_over_start_nodes_equals_monolithic(budget):
    """A small log budget walks blocks of start nodes; the counter hash keys
    on the global node id, so every row is the monolithic walk's."""
    adj = _mesh_graph(9)
    cfg = twalker.WalkConfig(walks_per_node=12, p_halt=0.05, max_walk_length=4)
    graph = pack_laplacian(adj)
    whole = twalker.sample_dense_step_matrices(graph, 5, cfg)
    blocked = k4.sample_dense_step_matrices_plain(graph, 5, cfg, log_budget_bytes=budget)
    np.testing.assert_array_equal(blocked.numpy(), whole.numpy())


def test_plain_isolated_node_halts_at_once():
    adj = _mesh_graph(4)
    adj[5, :] = adj[:, 5] = 0.0
    cfg = twalker.WalkConfig(walks_per_node=9, p_halt=0.1, max_walk_length=4, ablation=True)
    graph = pack_dense(adj)  # the raw adjacency: node 5 has degree 0
    assert int(graph.degree[5]) == 0
    m = k4.sample_dense_step_matrices_plain(graph, 2, cfg)
    assert float(m[0, 5, 5]) == pytest.approx(1.0, abs=1e-6)
    assert bool((m[1:, 5, :] == 0).all())
    want = np.asarray(jwalker.sample_dense_step_matrices(
        jpack_dense(adj), jax.random.PRNGKey(2),
        JWalkConfig(walks_per_node=9, p_halt=0.1, max_walk_length=4, ablation=True)))
    np.testing.assert_allclose(m.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,steps,want", [
    (900, 10, 10),      # the ablation protocol: 36 KB, one pass
    (4096, 10, 10),     # 160 KB: above the 48 KB default, below the 227 KB a block may have
    (4096, 14, 14),
    (4096, 16, 14),     # 256 KB would not fit: two passes
    (4096, 100, 14),
    (64, 500, 500),
])
def test_steps_per_pass_fits_shared_memory(n, steps, want):
    got = k4.steps_per_pass(n, steps)
    assert got == want
    assert 4 * got * n + 8 * steps <= k4.MAX_DYNAMIC_SMEM_BYTES
    if got < steps:  # one more step would not fit
        assert 4 * (got + 1) * n + 8 * steps > k4.MAX_DYNAMIC_SMEM_BYTES


def test_steps_per_pass_refuses_a_table_that_leaves_no_room():
    with pytest.raises(ValueError, match="shared memory"):
        k4.steps_per_pass(4096, 28_000)


@pytest.mark.parametrize("wpn,cells,want", [
    (1, 40, 32), (32, 40, 32), (33, 40, 64), (50, 48, 64), (1000, 9000, 1024),
    (1, 3210, 416),      # one walk on the PEMS graph: the cells size the block
    (64, 40960, 1024),   # few walks at N = 4096: 1024 threads zero and write 160 KB
    (8192, 40960, 1024),
])
def test_block_threads_whole_warps_up_to_1024(wpn, cells, want):
    assert k4.block_threads(wpn, cells) == want


def test_cuda_wrapper_refuses_cpu_tensors_and_large_graphs():
    """The wrapper never gives way to the plain version: a CPU graph raises."""
    graph = pack_laplacian(_mesh_graph(4))
    with pytest.raises(ValueError, match="CUDA device"):
        k4.sample_dense_step_matrices_cuda(graph, 0, twalker.WalkConfig())
    assert k4.launches == 0
    assert k4.MAX_NODES == 4096
    n = k4.MAX_NODES + 1
    big = PackedGraph(torch.zeros((n, 1), dtype=torch.int32), torch.zeros((n, 1)),
                      torch.zeros(n, dtype=torch.int32))
    with pytest.raises(ValueError):
        k4.sample_dense_step_matrices_cuda(big, 0, twalker.WalkConfig(walks_per_node=8))


def test_fused_phi_matches_two_stage(toy_cycle_adj):
    cfg = dict(walks_per_node=30, p_halt=0.2, max_walk_length=3)
    f = np.asarray([1.0, 0.5, 0.25], np.float32)
    graph = pack_laplacian(toy_cycle_adj)
    mats = twalker.sample_dense_step_matrices(graph, 4, twalker.WalkConfig(**cfg))
    got = twalker.fused_phi(graph, 4, f, twalker.WalkConfig(**cfg))
    np.testing.assert_allclose(got.numpy(), torch.einsum("l,lij->ij", torch.from_numpy(f), mats).numpy(),
                               atol=1e-5)
    want = jwalker.fused_phi(jpack_laplacian(toy_cycle_adj), jax.random.PRNGKey(4), f,
                             JWalkConfig(**cfg))
    # dense input: Laplacian weights may differ by two ulps between the packages
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
