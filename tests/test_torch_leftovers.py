"""The JAX package's functions that lie on no driver path, against the port
on the CPU: ``graphs.laplacian`` / ``packed_to_dense`` /
``generate_noisy_samples``, ``modulators.geometric_modulator``, column-major
``batched_cg`` (with a preconditioner and a start) and ``lanczos``, the
uncontracted ``make_ktt_matvec*``, the uncontracted ``stencil_phi_*``
products, ``utils.profiling.torch_trace`` and ``utils.plotting``.

Tolerances: integer and single-entry results exactly; the Laplacian, the
packed graph and the geometric modulator exactly; sums of float32 terms in
another order 1e-5 of the largest reference entry (the stencil products
1e-4 absolute against the Pallas kernel, as the JAX package's kernel tests
use); CG and Lanczos, whose float32 iterations compound the order, 1e-4,
with equal iteration counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgp_tpu import features as jfeat
from graphgp_tpu import graphs as jgraphs
from graphgp_tpu import linalg as jlin
from graphgp_tpu import modulators as jmod
from graphgp_tpu import walker as jwalker
from graphgp_tpu.gp import iterative as jiter
from graphgp_tpu.gp import params as JP
from graphgp_tpu.pallas_kernels import stencil as ps
from graphgp_tpu_torch import convert, features, graphs, linalg, modulators
from graphgp_tpu_torch.gp import iterative

N = 48


@pytest.fixture(scope="module")
def er():
    """The conftest's 48-node Erdős–Rényi graph, once for the module."""
    rng = np.random.default_rng(7)
    adj = (rng.random((N, N)) < 0.12).astype(np.float32)
    adj = np.triu(adj, 1)
    adj = adj + adj.T
    for i in range(N):
        if adj[i].sum() == 0:
            adj[i, (i + 1) % N] = adj[(i + 1) % N, i] = 1.0
    return adj


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def gram_problem(er):
    """Dense and walk-log features of the JAX walks on the ER graph, the
    diffusion parameters, a train set and right-hand sides."""
    cfg = jwalker.WalkConfig(walks_per_node=32, p_halt=0.1, max_walk_length=4)
    log = jwalker.sample_walk_log(jgraphs.pack_laplacian(er), jax.random.PRNGKey(3), cfg)
    dense = jwalker.dense_step_matrices(log, cfg)
    params = {k: np.asarray(v) for k, v in
              JP.init_params("diffusion", 4, jax.random.PRNGKey(1), noise=0.3).items()}
    tr = np.arange(1, N, 2).astype(np.int32)
    b = np.random.default_rng(0).normal(size=(tr.shape[0], 3)).astype(np.float32)
    return dict(
        jdense=jfeat.DenseFeatures(dense), jlog=jfeat.LogFeatures(log, num_target_nodes=N),
        tdense=convert.dense_from_numpy(np.asarray(dense)),
        tlog=convert.log_features_from_jax(np.asarray(log.curs), np.asarray(log.loads), N),
        jparams={k: jnp.asarray(v) for k, v in params.items()},
        tparams=convert.params_from_jax(params), tr=tr, b=b)


# ---------------------------------------------------------------------------
# graphs, modulators
# ---------------------------------------------------------------------------


def test_laplacian_matches_jax(er):
    np.testing.assert_array_equal(graphs.laplacian(er).numpy(), np.asarray(jgraphs.laplacian(er)))
    assert graphs.laplacian(torch.from_numpy(er)).dtype == torch.float32


@pytest.mark.parametrize("graph", ["ring", "er"])
def test_packed_to_dense_matches_jax(er, graph):
    from graphgp_tpu.data.synthetic import generate_ring_data

    import scipy.sparse as sp

    # sparse input: both packages pack it through numpy float64, bit for bit
    adj = generate_ring_data(40)["adjacency"] if graph == "ring" else sp.csr_matrix(er)
    ref = np.asarray(jgraphs.packed_to_dense(jgraphs.pack_laplacian(adj)))
    got = graphs.packed_to_dense(graphs.pack_laplacian(adj)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_generate_noisy_samples_matches_jax_under_its_draws(er):
    kernel = np.asarray(jgraphs.normalized_laplacian(er)) @ np.asarray(
        jgraphs.normalized_laplacian(er)).T + 0.5 * np.eye(N, dtype=np.float32)
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    eps = tuple(torch.from_numpy(np.asarray(jax.random.normal(k, (N, 1)))) for k in (k1, k2))
    ref = np.asarray(jgraphs.generate_noisy_samples(key, jnp.asarray(kernel), noise_std=0.2))
    got = graphs.generate_noisy_samples(torch.from_numpy(kernel), 0.2, eps=eps).numpy()
    assert got.shape == (N, 1)
    assert _rel(got, ref) <= 1e-5
    drawn = graphs.generate_noisy_samples(torch.from_numpy(kernel),
                                          generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (N, 1) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("rho", [0.5, -0.8, 1.3])
def test_geometric_modulator_matches_jax(rho):
    np.testing.assert_allclose(modulators.geometric_modulator(6, rho).numpy(),
                               np.asarray(jmod.geometric_modulator(6, rho)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The uncontracted Gram matvecs and column-major solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "log"])
def test_ktt_matvecs_match_jax(gram_problem, layout):
    g = gram_problem
    jf, tf = g[f"j{layout}"], g[f"t{layout}"]
    tr, b = g["tr"], g["b"]
    jcarry = (g["jparams"], jf, jnp.asarray(tr))
    tcarry = (g["tparams"], tf, torch.from_numpy(tr.astype(np.int64)))
    ref = jiter.make_ktt_matvec("diffusion")(jcarry, jnp.asarray(b))
    got = iterative.make_ktt_matvec("diffusion")(tcarry, torch.from_numpy(b))
    assert _rel(got.numpy(), ref) <= 1e-5
    ref1 = jiter.make_ktt_matvec("diffusion")(jcarry, jnp.asarray(b[:, 0]))
    got1 = iterative.make_ktt_matvec("diffusion")(tcarry, torch.from_numpy(b[:, 0].copy()))
    assert _rel(got1.numpy(), ref1) <= 1e-5
    bm = np.ascontiguousarray(b.T)
    ref = jiter.make_ktt_matvec_bm("diffusion")(jcarry, jnp.asarray(bm))
    got = iterative.make_ktt_matvec_bm("diffusion")(tcarry, torch.from_numpy(bm))
    assert _rel(got.numpy(), ref) <= 1e-5
    mask = (np.arange(tr.shape[0]) % 5 != 0).astype(np.float32)
    ref = jiter.make_ktt_matvec_bm_masked("diffusion")((*jcarry, jnp.asarray(mask)),
                                                      jnp.asarray(bm))
    got = iterative.make_ktt_matvec_bm_masked("diffusion")((*tcarry, torch.from_numpy(mask)),
                                                          torch.from_numpy(bm))
    assert _rel(got.numpy(), ref) <= 1e-5


def _jacobi(features_rows, params_noise):
    """Diagonal of K_tt + σ²I from Φ's train rows."""
    return (features_rows ** 2).sum(-1) + params_noise


@pytest.mark.parametrize("precond", [False, True], ids=["plain", "jacobi"])
def test_column_major_cg_matches_jax(gram_problem, precond):
    """batched_cg(batch_axis=1) on (n_train, B) with an optional Jacobi
    preconditioner and a nonzero start: the JAX package's iterations, count
    and all."""
    g = gram_problem
    tr = g["tr"]
    f_t = iterative.P.modulator("diffusion", g["tparams"], 4)
    diag = _jacobi(g["tdense"].rows(f_t, torch.from_numpy(tr.astype(np.int64))),
                   iterative.P.noise_variance(g["tparams"])).detach()
    diag_np = diag.numpy()
    x0 = np.full_like(g["b"], 0.1)
    jpc = (lambda _c, r: r / jnp.asarray(diag_np)[:, None]) if precond else None
    tpc = (lambda _c, r: r / diag[:, None]) if precond else None
    ref = jlin.batched_cg(jiter.make_ktt_matvec("diffusion"),
                          (g["jparams"], g["jdense"], jnp.asarray(tr)), jnp.asarray(g["b"]),
                          tol=1e-5, max_iters=200, precond=jpc, x0=jnp.asarray(x0))
    got = linalg.batched_cg(iterative.make_ktt_matvec("diffusion"),
                            (g["tparams"], g["tdense"], torch.from_numpy(tr.astype(np.int64))),
                            torch.from_numpy(g["b"]), tol=1e-5, max_iters=200,
                            precond=tpc, x0=torch.from_numpy(x0), batch_axis=1)
    assert got.iterations == int(ref.iterations)
    assert got.x.shape == tuple(ref.x.shape)
    assert _rel(got.x.numpy(), ref.x) <= 1e-4
    # both stopped for the same reason (the final residuals themselves sit at
    # float32 noise, ~1e-6 of |b|, and differ in their first digit)
    assert (got.residual_norm <= 1e-5).all() and (np.asarray(ref.residual_norm) <= 1e-5).all()
    # one vector, and the batch-major layout of the same systems
    one = linalg.batched_cg(iterative.make_ktt_matvec("diffusion"),
                            (g["tparams"], g["tdense"], torch.from_numpy(tr.astype(np.int64))),
                            torch.from_numpy(g["b"][:, 0].copy()), tol=1e-5, max_iters=200,
                            precond=tpc, batch_axis=1)
    ref1 = jlin.batched_cg(jiter.make_ktt_matvec("diffusion"),
                           (g["jparams"], g["jdense"], jnp.asarray(tr)), jnp.asarray(g["b"][:, 0]),
                           tol=1e-5, max_iters=200, precond=jpc)
    assert one.x.shape == (tr.shape[0],) and one.iterations == int(ref1.iterations)
    assert _rel(one.x.numpy(), ref1.x) <= 1e-4
    rows = linalg.batched_cg(
        iterative.make_ktt_matvec_bm("diffusion"),
        (g["tparams"], g["tdense"], torch.from_numpy(tr.astype(np.int64))),
        torch.from_numpy(np.ascontiguousarray(g["b"].T)), tol=1e-5, max_iters=200,
        precond=None if tpc is None else (lambda _c, r: r / diag[None, :]))
    assert rows.iterations == got.iterations
    assert _rel(rows.x.T.numpy(), got.x.numpy()) <= 1e-4


def _rows_problem(g):
    """The batch-major Gram operator of the dense features, its carry and
    right-hand sides (B, n_train)."""
    carry = (g["tparams"], g["tdense"], torch.from_numpy(g["tr"].astype(np.int64)))
    b = torch.from_numpy(np.ascontiguousarray(g["b"].T))
    return iterative.make_ktt_matvec_bm("diffusion"), carry, b


def test_an_operator_that_returns_its_dot_solves_to_the_same_bits(gram_problem):
    """An operator may return ``(A p, ⟨p, A p⟩)``; the loop takes that dot
    as its denominator, and a dot formed as the loop forms it gives the
    loop's own bits."""
    matvec, carry, b = _rows_problem(gram_problem)

    def with_dot(c, p):
        ap = matvec(c, p)
        return ap, (p * ap).sum(-1)

    with torch.no_grad():
        ref = linalg.batched_cg(matvec, carry, b, tol=1e-5, max_iters=200)
        got = linalg.batched_cg(with_dot, carry, b, tol=1e-5, max_iters=200)
    assert 0 < ref.iterations < 200 and got.iterations == ref.iterations
    assert torch.equal(got.x, ref.x) and torch.equal(got.residual_norm, ref.residual_norm)


@pytest.mark.parametrize("start", ["zero", "x0"])
def test_a_solve_applies_its_operator_once_an_iteration(gram_problem, start):
    """Without ``x0`` the loop starts at r = b and applies the operator once
    an iteration; with one it applies it once more, for ``b − A x0``."""
    matvec, carry, b = _rows_problem(gram_problem)
    calls = []

    def counted(c, p):
        calls.append(1)
        return matvec(c, p)

    x0 = torch.full_like(b, 0.1) if start == "x0" else None
    with torch.no_grad():
        res = linalg.batched_cg(counted, carry, b, tol=1e-5, max_iters=200, x0=x0)
    assert res.iterations > 0
    assert len(calls) == res.iterations + (x0 is not None)


def test_column_major_lanczos_matches_jax(gram_problem):
    g = gram_problem
    tr = g["tr"]
    v0 = np.random.default_rng(4).normal(size=(tr.shape[0], 2)).astype(np.float32)
    jcarry = (g["jparams"], g["jdense"], jnp.asarray(tr))
    tcarry = (g["tparams"], g["tdense"], torch.from_numpy(tr.astype(np.int64)))
    ra, rb = jlin.lanczos(jiter.make_ktt_matvec("diffusion"), jcarry, jnp.asarray(v0), 8)
    a, b = linalg.lanczos(iterative.make_ktt_matvec("diffusion"), tcarry, torch.from_numpy(v0), 8,
                          batch_axis=1)
    assert a.shape == tuple(ra.shape) and b.shape == tuple(rb.shape)
    assert _rel(a.numpy(), ra) <= 1e-4 and _rel(b.numpy(), rb) <= 1e-4
    ra1, rb1 = jlin.lanczos(jiter.make_ktt_matvec("diffusion"), jcarry, jnp.asarray(v0[:, 0]), 8)
    a1, b1 = linalg.lanczos(iterative.make_ktt_matvec("diffusion"), tcarry,
                            torch.from_numpy(v0[:, 0].copy()), 8, batch_axis=1)
    assert a1.shape == (8,) and b1.shape == (7,)
    assert _rel(a1.numpy(), ra1) <= 1e-4 and _rel(b1.numpy(), rb1) <= 1e-4


# ---------------------------------------------------------------------------
# The uncontracted stencil products
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stencil():
    """A random stencil with wraparound-style and far offsets, N not a lane
    multiple (the Pallas zero tail)."""
    n, l = 515, 3
    rng = np.random.default_rng(2)
    offs = np.unique(np.concatenate([[0, 1, n - 1, -2], rng.integers(-7, 8, 5)])).astype(np.int32)
    vals = rng.normal(size=(l, offs.size, n)).astype(np.float32)
    f = rng.normal(size=l).astype(np.float32)
    return vals, offs, f


@pytest.mark.parametrize("b", [1, 5])
def test_stencil_phi_products_match_pallas_and_jax(stencil, b):
    vals, offs, f = stencil
    n = vals.shape[2]
    v = np.random.default_rng(b).normal(size=(b, n)).astype(np.float32)
    mats = convert.stencil_from_numpy(vals, offs)
    jmats = jfeat.StencilStepMatrices(vals=jnp.asarray(vals), offsets=offs)
    w = jnp.einsum("l,lsn->sn", jnp.asarray(f), jnp.asarray(vals))
    w_shift = ps.shifted_weights(w, ps.center_offsets(offs, n))
    pallas_m = np.asarray(ps.matvec_bm(w, jnp.asarray(v), offs, interpret=True))
    pallas_r = np.asarray(ps.rmatvec_bm(w_shift, jnp.asarray(v), offs, interpret=True))
    got_m = features.stencil_phi_matvec_bm(mats, torch.from_numpy(f), torch.from_numpy(v))
    got_r = features.stencil_phi_rmatvec_bm(mats, torch.from_numpy(f), torch.from_numpy(v))
    np.testing.assert_allclose(got_m.numpy(), pallas_m, atol=1e-4)
    np.testing.assert_allclose(got_r.numpy(), pallas_r, atol=1e-4)
    # column-major and 1-D forms against the JAX package's roll chains
    vc = np.ascontiguousarray(v.T)
    vt = torch.from_numpy(vc)
    for jfn, tfn in ((jfeat.stencil_phi_matvec, features.stencil_phi_matvec),
                     (jfeat.stencil_phi_rmatvec, features.stencil_phi_rmatvec)):
        ref = np.asarray(jfn(jmats, jnp.asarray(f), jnp.asarray(vc)))
        assert _rel(tfn(mats, torch.from_numpy(f), vt).numpy(), ref) <= 1e-5
        ref1 = np.asarray(jfn(jmats, jnp.asarray(f), jnp.asarray(vc[:, 0])))
        got1 = tfn(mats, torch.from_numpy(f), torch.from_numpy(vc[:, 0].copy()))
        assert got1.shape == (n,) and _rel(got1.numpy(), ref1) <= 1e-5
    rows = np.asarray([0, 1, 200, n - 1], np.int32)
    ref_rows = np.asarray(jfeat.stencil_phi_rows(jmats, jnp.asarray(f), jnp.asarray(rows)))
    got_rows = features.stencil_phi_rows(mats, torch.from_numpy(f), torch.from_numpy(rows))
    assert _rel(got_rows.numpy(), ref_rows) <= 1e-6
    # StencilFeatures carries them, as the JAX class does
    sf = features.StencilFeatures(mats)
    torch.testing.assert_close(sf.matvec_bm(torch.from_numpy(f), torch.from_numpy(v)), got_m)


# ---------------------------------------------------------------------------
# utils: trace and plots
# ---------------------------------------------------------------------------


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    import json

    from graphgp_tpu_torch.utils.profiling import torch_trace

    with torch_trace(str(tmp_path)):
        (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        trace = json.load(fh)
    assert trace["traceEvents"]


def test_plotting_under_agg(tmp_path, er):
    matplotlib = pytest.importorskip("matplotlib")
    pytest.importorskip("networkx")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from graphgp_tpu_torch.utils.plotting import plot_gp_fit, plot_network_graph

    ax = plot_network_graph(er, values=np.arange(N, dtype=float))
    ax.figure.savefig(tmp_path / "graph.png")
    te = np.arange(0, N, 3)
    ax = plot_gp_fit(np.arange(1, N, 3), np.zeros(16), te, np.sin(te), np.full(te.shape, 0.1),
                     y_true=np.sin(np.arange(N)))
    ax.figure.savefig(tmp_path / "fit.png")
    plt.close("all")
    assert (tmp_path / "graph.png").stat().st_size > 0 and (tmp_path / "fit.png").stat().st_size > 0
