"""``graphgp_tpu_torch/kernels.py`` and ``graphs.normalized_laplacian`` against
the JAX package, on the CPU (``device="cpu"``: the plain path).

Tolerances: the walks are bit-identical, so GRF step matrices differ by the
order of one scatter-add (1e-6) and kernels ``ΦΦᵀ`` built from them by a
float32 matrix product of a few dozen rows (rtol 1e-5, atol 1e-5). Dense
adjacency inputs go through a float32 ``rsqrt`` whose last bits differ
between XLA's CPU and torch (≤ 2 ulps of each Laplacian weight, ROADMAP
Queue 3), which the tolerances below cover. ``eigh``-based kernels compare
the reassembled matrix (eigenvector signs are free): atol 2e-5. The PoFM
functions are up to ten float32 matrix products: rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import graphgp_tpu as jgg
from graphgp_tpu import kernels as jkernels
from graphgp_tpu.data import synthetic as jsynthetic
import graphgp_tpu_torch as tgg
from graphgp_tpu_torch import kernels as tkernels
from graphgp_tpu_torch.features import DenseFeatures, StencilFeatures
from graphgp_tpu_torch.features import contract

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def grid_adj():
    return jsynthetic.generate("grid", 49, seed=1)["adjacency"]  # scipy CSR


def test_normalized_laplacian_within_two_ulps(er_adj):
    want = np.asarray(jgg.normalized_laplacian(jnp.asarray(er_adj)))
    got = tgg.normalized_laplacian(er_adj)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # two ulps of a weight in (0, 1]: 2 · 2^-24 at most
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.5e-7)
    np.testing.assert_array_equal(np.diag(got.numpy()), np.ones(er_adj.shape[0], np.float32))
    # a tensor in gives a tensor on its device; an isolated node keeps a unit self-loop
    adj = torch.zeros((3, 3))
    adj[0, 1] = adj[1, 0] = 1.0
    lap = tgg.normalized_laplacian(adj)
    np.testing.assert_array_equal(lap.numpy(), np.asarray([[1, -1, 0], [-1, 1, 0], [0, 0, 1]], np.float32))


@pytest.mark.parametrize("ablation", [False, True])
def test_step_matrices_for_adjacency_matches_jax(grid_adj, ablation):
    kw = dict(walks_per_node=24, p_halt=0.1, max_walk_length=4, ablation=ablation)
    # the JAX ablation path packs np.asarray(adj): hand it the dense matrix
    jadj = grid_adj.toarray() if ablation else grid_adj
    want = np.asarray(jkernels.step_matrices_for_adjacency(jadj, jax.random.PRNGKey(9), **kw))
    got = tkernels.step_matrices_for_adjacency(grid_adj, 9, **kw, **CPU)
    assert got.shape == (4, 49, 49)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_step_matrices_ablation_walks_the_raw_adjacency(grid_adj):
    """Under ``ablation`` the walk runs on A itself with load = weight: no
    self-loops, every visited cell is a sum of ones over W."""
    m = tkernels.step_matrices_for_adjacency(grid_adj, 1, walks_per_node=10, p_halt=0.1,
                                             max_walk_length=3, ablation=True, **CPU)
    a = grid_adj.toarray()
    assert bool(((m[1] != 0).numpy() <= (a != 0)).all())  # step 1 lands on neighbours only
    np.testing.assert_allclose((m[1] * 10).numpy(), np.round((m[1] * 10).numpy()), atol=1e-5)
    lap = tkernels.step_matrices_for_adjacency(grid_adj, 1, walks_per_node=10, p_halt=0.1,
                                               max_walk_length=3, **CPU)
    assert bool((torch.diagonal(lap[1]) != 0).any())  # the Laplacian has unit self-loops


def test_step_matrices_method_values(grid_adj):
    kw = dict(walks_per_node=8, max_walk_length=3)
    auto = tkernels.step_matrices_for_adjacency(grid_adj, 2, method="auto", **kw, **CPU)
    gather = tkernels.step_matrices_for_adjacency(grid_adj, 2, method="gather", **kw, **CPU)
    np.testing.assert_array_equal(auto.numpy(), gather.numpy())
    with pytest.raises(ValueError, match="unknown step-matrix method"):
        tkernels.step_matrices_for_adjacency(grid_adj, 2, method="pallas", **kw, **CPU)
    # forcing the kernel on the CPU raises: it never gives way to the gather walker
    with pytest.raises(ValueError, match="CUDA device"):
        tkernels.step_matrices_for_adjacency(grid_adj, 2, method="cuda", **kw, **CPU)


def test_entry_points_default_to_the_card_and_raise_without_one(grid_adj):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    for call in (
        lambda: tkernels.step_matrices_for_adjacency(grid_adj, 0),
        lambda: tkernels.features_for_adjacency(grid_adj, 0),
        lambda: tkernels.fast_general_grf_kernel(grid_adj, [1.0, 0.5]),
        lambda: tkernels.diffusion_kernel(grid_adj),
        lambda: tkernels.pofm_features(grid_adj),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_features_for_adjacency_guardrail():
    """Above the dense limit the entry point switches to the blocked pipeline
    and the auto (stencil) layout; both operators give the same product."""
    adj = jsynthetic.generate("grid", 256, seed=1)["adjacency"]
    dense = tkernels.features_for_adjacency(adj, 0, walks_per_node=32, max_walk_length=3, **CPU)
    assert isinstance(dense, DenseFeatures)
    sparse = tkernels.features_for_adjacency(adj, 0, walks_per_node=32, max_walk_length=3,
                                             dense_bytes_limit=1, **CPU)
    assert isinstance(sparse, StencilFeatures)
    f = torch.tensor([1.0, 0.5, 0.25])
    v = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 256)).astype(np.float32))
    np.testing.assert_allclose(contract(sparse, f).matvec_bm(v).numpy(),
                               dense.matvec_bm(f, v).numpy(), atol=1e-4, rtol=1e-4)
    # and the JAX package's dense operator is the same one
    want = jkernels.features_for_adjacency(adj, jax.random.PRNGKey(0), walks_per_node=32,
                                           max_walk_length=3)
    np.testing.assert_allclose(dense.step_matrices.numpy(), np.asarray(want.step_matrices),
                               rtol=1e-6, atol=1e-6)


def test_fast_general_grf_kernel_quickstart(toy_cycle_adj):
    want = np.asarray(jgg.fast_general_grf_kernel(
        toy_cycle_adj, modulator_vector=[1.0, 0.5, 0.25], walks_per_node=50, p_halt=0.1))
    k = tgg.fast_general_grf_kernel(toy_cycle_adj, modulator_vector=[1.0, 0.5, 0.25],
                                    walks_per_node=50, p_halt=0.1, **CPU)
    assert k.shape == (4, 4)
    np.testing.assert_allclose(k.numpy(), k.numpy().T, atol=1e-6)  # symmetric
    assert float(torch.linalg.eigvalsh(k).min()) > -1e-5           # PSD
    np.testing.assert_allclose(k.numpy(), want, rtol=1e-5, atol=1e-5)  # default seed 42 in both


def test_fast_general_grf_kernel_length_check(toy_cycle_adj):
    with pytest.raises(ValueError, match="must match"):
        tgg.fast_general_grf_kernel(toy_cycle_adj, [1.0, 0.5, 0.25], max_walk_length=5, **CPU)
    k = tgg.fast_general_grf_kernel(toy_cycle_adj, [1.0, 0.5, 0.25], max_walk_length=3, seed=7, **CPU)
    want = jgg.fast_general_grf_kernel(toy_cycle_adj, [1.0, 0.5, 0.25], max_walk_length=3,
                                       key=jax.random.PRNGKey(7))
    np.testing.assert_allclose(k.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_fast_diffusion_grf_kernel_matches_jax_and_converges(grid_adj):
    kw = dict(beta=0.8, walks_per_node=64, p_halt=0.1, max_walk_length=6)
    want = np.asarray(jgg.fast_diffusion_grf_kernel(grid_adj, key=jax.random.PRNGKey(3), **kw))
    got = tgg.fast_diffusion_grf_kernel(grid_adj, seed=3, **kw, **CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    exact = tgg.diffusion_kernel(grid_adj, beta=0.8, **CPU)
    err = {w: float((tgg.fast_diffusion_grf_kernel(grid_adj, beta=0.8, walks_per_node=w,
                                                   max_walk_length=8, **CPU) - exact).abs().max())
           for w in (20, 2000)}
    assert err[2000] < 0.1 and err[2000] < err[20]


@pytest.mark.parametrize("beta", [0.5, 2.0])
def test_diffusion_kernel_matches_jax(grid_adj, er_adj, beta):
    for adj in (grid_adj.toarray(), er_adj):
        want = np.asarray(jgg.diffusion_kernel(adj, beta=beta))
        got = tgg.diffusion_kernel(adj, beta=beta, **CPU)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    # scipy sparse input is densified
    np.testing.assert_allclose(tgg.diffusion_kernel(grid_adj, beta=beta, **CPU).numpy(),
                               tgg.diffusion_kernel(grid_adj.toarray(), beta=beta, **CPU).numpy(),
                               atol=1e-6)


def test_pofm_functions_match_jax(er_adj):
    want = np.asarray(jgg.feature_matrix_kernel(er_adj, beta=1.5, max_expansion=8))
    got = tgg.feature_matrix_kernel(er_adj, beta=1.5, max_expansion=8, **CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    coeffs = np.asarray([0.7, -0.2, 0.05, 0.01], np.float32)
    want = np.asarray(jgg.general_pofm_feature_matrix(er_adj, jnp.asarray(coeffs)))
    got = tgg.general_pofm_feature_matrix(er_adj, coeffs, **CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    for on_adjacency in (False, True):
        want = np.asarray(jkernels.pofm_features(er_adj, max_expansion=5, on_adjacency=on_adjacency))
        got = tkernels.pofm_features(sp.csr_matrix(er_adj), max_expansion=5,
                                     on_adjacency=on_adjacency, **CPU)
        assert got.shape == (5, 48, 48)
        np.testing.assert_array_equal(got[0].numpy(), np.eye(48, dtype=np.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_grf_kernel_unbiased_two_explicit_seeds(grid_adj):
    """``K = Φ₁Φ₂ᵀ`` from two independent walks. The JAX function splits one
    key, which no integer seed reproduces, so the reference is assembled from
    the JAX gather walker at the same two seeds."""
    f = np.asarray([1.0, -0.4, 0.1], np.float32)
    got = tgg.grf_kernel_unbiased(grid_adj, f, walks_per_node=40, p_halt=0.1, seeds=(42, 84), **CPU)
    cfg = jgg.WalkConfig(walks_per_node=40, p_halt=0.1, max_walk_length=3)
    graph = jgg.pack_laplacian(grid_adj)
    phis = [jnp.einsum("l,lij->ij", jnp.asarray(f),
                       jgg.sample_dense_step_matrices(graph, jax.random.PRNGKey(s), cfg))
            for s in (42, 84)]
    np.testing.assert_allclose(got.numpy(), np.asarray(phis[0] @ phis[1].T), rtol=1e-5, atol=1e-5)
    assert float((got - got.T).abs().max()) > 1e-4  # two walks: not symmetric
    same = tgg.grf_kernel_unbiased(grid_adj, f, walks_per_node=40, p_halt=0.1, seeds=(42, 42), **CPU)
    np.testing.assert_allclose(same.numpy(), same.numpy().T, atol=1e-6)


def test_gram_from_phi_matches_jax():
    rng = np.random.default_rng(0)
    phi = rng.normal(size=(12, 9)).astype(np.float32)
    i1, i2 = np.asarray([0, 3, 11]), np.asarray([2, 3, 5])
    t = torch.from_numpy(phi)
    for kw_j, kw_t in (
        (dict(), dict()),
        (dict(idx1=i1), dict(idx1=i1)),
        (dict(idx1=i1, idx2=i2), dict(idx1=torch.from_numpy(i1), idx2=list(i2))),
        (dict(idx1=i1, idx2=i2, diag=True), dict(idx1=i1, idx2=i2, diag=True)),
    ):
        want = np.asarray(jgg.gram_from_phi(jnp.asarray(phi), **kw_j))
        got = tgg.gram_from_phi(t, **kw_t)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_package_exports_follow_the_jax_package():
    for name in ("normalized_laplacian", "normalized_laplacian_csr", "pack_csr", "pack_dense",
                 "pack_laplacian", "diffusion_kernel", "fast_diffusion_grf_kernel",
                 "fast_general_grf_kernel", "feature_matrix_kernel", "general_pofm_feature_matrix",
                 "gram_from_phi", "grf_kernel_unbiased", "step_matrices_for_adjacency",
                 "DenseFeatures", "EllFeatures", "StencilFeatures", "ell_to_stencil",
                 "diffusion_modulator", "free_modulator_init", "blocked_ell_features",
                 "WalkConfig", "WalkLog", "dense_step_matrices", "fused_phi",
                 "sample_dense_step_matrices", "sample_walk_log"):
        assert hasattr(jgg, name) and hasattr(tgg, name), name
    from graphgp_tpu_torch import cuda_kernels, gp

    assert callable(cuda_kernels.sample_dense_step_matrices_cuda)
    assert callable(cuda_kernels.sample_dense_step_matrices_plain)
    assert gp.spectral.SpectralDiffusionFeatures is not None
