"""Linear algebra and the iterative GP against the JAX package, given the same
draws (probes, ε₁/ε₂, initial parameters) as numpy arrays.

Solves run to a tight tolerance (1e-6) so both packages' CG converge fully
instead of stopping at different iterations; what remains is float32
summation order, amplified a little by the solves: rtol 1e-4 on values and
gradients unless a comment says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgp_tpu import features as jfeat
from graphgp_tpu import graphs as jgraphs
from graphgp_tpu import linalg as jlin
from graphgp_tpu import walker as jwalker
from graphgp_tpu.data.synthetic import generate
from graphgp_tpu.gp import iterative as jit_
from graphgp_tpu_torch import linalg as tlin
from graphgp_tpu_torch.convert import params_from_jax, stencil_from_numpy
from graphgp_tpu_torch.features import StencilFeatures, contract, step_rows
from graphgp_tpu_torch.gp import iterative as tit
from graphgp_tpu_torch.gp import params as tparams

RTOL = 1e-4


# ---------------------------------------------------------------------------
# Linear algebra on a fixed SPD operator A = M Mᵀ + diag(d)
# ---------------------------------------------------------------------------


def _spd_problem(n=40, b=3, seed=0):
    rng = np.random.default_rng(seed)
    m = (rng.normal(size=(n, n)) / np.sqrt(n)).astype(np.float32)
    d = rng.uniform(0.5, 1.5, n).astype(np.float32)
    rhs = rng.normal(size=(b, n)).astype(np.float32)
    c = rng.normal(size=(b, n)).astype(np.float32)
    return m, d, rhs, c


def _mv_jax(carry, v):
    m, d = carry
    return (v @ m) @ m.T + v * d


def _mv_torch(carry, v):
    m, d = carry
    return (v @ m) @ m.T + v * d


def test_batched_cg_matches_jax_and_freezes_converged():
    m, d, rhs, _ = _spd_problem()
    rhs[1] *= 1e-3  # a system that converges at another iteration
    ref = jlin.batched_cg(_mv_jax, (jnp.asarray(m), jnp.asarray(d)), jnp.asarray(rhs),
                          tol=1e-6, max_iters=200, batch_axis=0)
    out = tlin.batched_cg(_mv_torch, (torch.from_numpy(m), torch.from_numpy(d)),
                          torch.from_numpy(rhs), tol=1e-6, max_iters=200)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=RTOL, atol=1e-5)
    a = m @ m.T + np.diag(d)
    np.testing.assert_allclose(out.x.numpy(), np.linalg.solve(a, rhs.T).T, rtol=1e-3, atol=1e-4)
    assert bool((out.residual_norm <= 1e-6).all())


def _block_problem(masked, t=40, seed=0):
    """The train block's operator on a random K_tt (σ² 0.05) and five rows:
    zero (no live iteration), one and three eigenvectors of the operator
    (live for about that many iterations) and two random rows."""
    rng = np.random.default_rng(seed)
    m = (rng.normal(size=(t, t)) / np.sqrt(t)).astype(np.float32)
    mask = torch.from_numpy((rng.random(t) < 0.8).astype(np.float32)) if masked else None
    carry = (torch.from_numpy(m @ m.T), torch.tensor(0.05), mask)
    matvec = tit.make_gram_matvec_block()
    a = matvec(carry, torch.eye(t)).double()
    _, q = torch.linalg.eigh((a + a.T) / 2)
    w = torch.from_numpy(rng.normal(size=(3, 5))).double()
    b = torch.zeros((5, t), dtype=torch.float64)
    b[1] = q[:, -1]
    b[2] = q[:, -3:] @ w[0, :3]
    b[3:] = torch.from_numpy(rng.normal(size=(2, t)))
    return matvec, carry, b.float()


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("case", ["converge", "max_iters", "x0", "one_row"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_cg_in_chunks_is_the_one_iteration_loop_bit_for_bit(masked, case, k):
    """The loop in chunks of k iterations with one host read a chunk (a CUDA
    graph's replay on a card) gives the one-iteration loop's x, residual and
    iterations, bit for bit, and reads the host at most once a chunk and
    once more: rows frozen at other iterations, a solve cut at max_iters 10
    (k 3 does not divide it), a start at x0 and a single vector."""
    from graphgp_tpu_torch.utils import profiling

    matvec, carry, b = _block_problem(masked)
    tol, max_iters, x0 = 1e-4, 200, None
    if case == "max_iters":
        tol, max_iters = 1e-7, 10
    elif case == "x0":
        x0 = 0.1 * torch.ones_like(b)
    elif case == "one_row":
        b = b[3]
    ref = tlin._batched_cg_rows(matvec, carry, b, tol, max_iters, x0, None)
    profiling.reset()
    profiling.enable()
    try:
        got = tlin._chunked_cg_rows(matvec, carry, b, tol, max_iters, x0, k)
        syncs = profiling.snapshot()["counts"]["host.syncs"]
    finally:
        profiling.disable()
        profiling.reset()
    assert got.iterations == ref.iterations
    assert torch.equal(got.x, ref.x) and torch.equal(got.residual_norm, ref.residual_norm)
    assert syncs <= -(-ref.iterations // k) + 1
    if case == "max_iters":
        assert ref.iterations == 10 and bool((ref.residual_norm > tol).any())
    elif case == "converge":
        assert ref.iterations < max_iters and bool((ref.residual_norm <= tol).all())
        # the rows freeze at different iterations
        early = tlin._batched_cg_rows(matvec, carry, b, tol, 3, x0, None).residual_norm
        assert bool((early[:3] <= tol).all()) and bool((early[3:] > tol).all())


def test_cg_solve_value_and_gradients_match_jax():
    m, d, rhs, c = _spd_problem()

    def loss_j(mm, dd, bb):
        x = jlin.cg_solve(_mv_jax, (mm, dd), bb, 1e-6, 200, 0)
        return jnp.sum(x * jnp.asarray(c))

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(m), jnp.asarray(d), jnp.asarray(rhs))
    mt, dt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (m, d, rhs))
    x = tlin.cg_solve(_mv_torch, (mt, dt), bt, 1e-6, 200)
    (x * torch.from_numpy(c)).sum().backward()
    for got, want in zip((mt.grad, dt.grad, bt.grad), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)


def test_slq_logdet_value_and_gradients_match_jax():
    m, d, _, _ = _spd_problem(n=48, seed=1)
    probes = np.asarray(jax.random.rademacher(jax.random.PRNGKey(0), (48, 8), jnp.float32)).T

    def ld_j(mm, dd):
        return jlin.slq_logdet(_mv_jax, (mm, dd), jnp.asarray(probes), 12, 1e-6, 200, 0)

    val_j, gj = jax.value_and_grad(ld_j, argnums=(0, 1))(jnp.asarray(m), jnp.asarray(d))
    mt, dt = (torch.from_numpy(a).requires_grad_(True) for a in (m, d))
    val = tlin.slq_logdet(_mv_torch, (mt, dt), torch.from_numpy(probes.copy()), 12, 1e-6, 200)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(val_j), rtol=RTOL)
    for got, want in zip((mt.grad, dt.grad), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-4)
    # and the estimate is a logdet: within the probe noise of the exact one
    exact = np.linalg.slogdet((m @ m.T + np.diag(d)).astype(np.float64))[1]
    assert abs(float(val.detach()) - exact) < 0.1 * abs(exact)


def test_lanczos_single_iteration_and_probes():
    m, d, _, _ = _spd_problem(n=16)
    q = torch.ones(2, 16)
    alphas, betas = tlin.lanczos(_mv_torch, (torch.from_numpy(m), torch.from_numpy(d)), q, 1)
    assert alphas.shape == (1, 2) and betas.shape == (0, 2)
    p = tlin.rademacher_probes(1000, 4, torch.Generator().manual_seed(0))
    assert p.shape == (4, 1000) and set(p.unique().tolist()) == {-1.0, 1.0}


# ---------------------------------------------------------------------------
# The GP on a stencil layout: both packages share one stencil from JAX.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stencil_pair():
    adj = generate("grid", 400, seed=0)["adjacency"]
    log = jwalker.sample_walk_log(jgraphs.pack_laplacian(adj), jax.random.PRNGKey(1),
                                  jwalker.WalkConfig(64, 0.1, 4))
    jm = jfeat.ell_to_stencil(jfeat.consolidate(log, jfeat.suggest_row_capacity(log)))
    jf = jfeat.StencilFeatures(jm)
    tf = StencilFeatures(stencil_from_numpy(np.asarray(jm.vals), np.asarray(jm.offsets)))
    y_all = generate("grid", 400, seed=0)["y_observed"].astype(np.float32)
    return jf, tf, y_all


def _padded_obs(y_all, n_real=30, cap=48, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.zeros(cap, np.int32)
    idx[:n_real] = rng.choice(y_all.size, n_real, replace=False)
    idx[5] = idx[3]  # a repeated observation, as BO revisits produce
    y = np.zeros(cap, np.float32)
    y[:n_real] = y_all[idx[:n_real]]
    mask = (np.arange(cap) < n_real).astype(np.float32)
    return idx, y, mask


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"raw_noise": np.float32(-1.5),
            "modulator": rng.normal(size=4).astype(np.float32)}


SETTINGS = dict(cg_tol=1e-6, cg_max_iters=300, num_probes=8, num_lanczos_iters=10)


def test_mll_cg_masked_value_and_gradients_match_jax(stencil_pair):
    jf, tf, y_all = stencil_pair
    idx, y, mask = _padded_obs(y_all)
    p0 = _params()
    key = jax.random.PRNGKey(4)
    js = jit_.CGSettings(**SETTINGS)

    def neg_mll(p):
        return -jit_.mll_cg(jf, p, jnp.asarray(idx), jnp.asarray(y), key, kind="free",
                            settings=js, mask=jnp.asarray(mask), num_real=jnp.float32(30))

    val_j, g_j = jax.value_and_grad(neg_mll)({k: jnp.asarray(v) for k, v in p0.items()})
    probes = np.asarray(jlin.rademacher_probes(key, idx.size, js.num_probes)).T.copy()

    p = {k: v.requires_grad_(True) for k, v in params_from_jax(p0).items()}
    val = -tit.mll_cg(tf, p, torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(y),
                      settings=tit.CGSettings(**SETTINGS), mask=torch.from_numpy(mask),
                      num_real=30.0, probes=torch.from_numpy(probes))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(val_j), rtol=RTOL)
    for k in p0:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(g_j[k]), rtol=RTOL, atol=1e-4)
    assert torch.all(p["modulator"].grad != 0)


def test_mll_cg_unmasked_and_full_space_agree(stencil_pair):
    """With distinct train ids the full-node-space operator gives the compact
    path's value (same probes, scattered into node space)."""
    _, tf, y_all = stencil_pair
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(rng.choice(400, 60, replace=False))
    y = torch.from_numpy(y_all[idx.numpy()])
    probes = tlin.rademacher_probes(60, 8, torch.Generator().manual_seed(3))
    full_probes = torch.zeros(8, 400).index_add(1, idx, probes)
    p = params_from_jax(_params())
    settings = tit.CGSettings(**SETTINGS)
    compact = tit.mll_cg(tf, p, idx, y, settings=settings, probes=probes)
    full = tit.mll_cg(tf, p, idx, y, settings=settings, probes=full_probes, full_space=True)
    np.testing.assert_allclose(float(full), float(compact), rtol=RTOL)


def test_pathwise_predict_matches_jax_given_same_draws(stencil_pair):
    jf, tf, y_all = stencil_pair
    idx, y, mask = _padded_obs(y_all, seed=1)
    p0 = _params(1)
    test_idx = np.arange(0, 400, 7, dtype=np.int32)
    key = jax.random.PRNGKey(9)
    js = jit_.CGSettings(**SETTINGS)
    ref = jit_.pathwise_predict(
        jf, {k: jnp.asarray(v) for k, v in p0.items()}, jnp.asarray(idx), jnp.asarray(y),
        jnp.asarray(test_idx), key, kind="free", num_samples=5, settings=js,
        mask=jnp.asarray(mask),
    )
    k1_, k2_ = jax.random.split(key)
    eps1 = np.asarray(jax.random.normal(k1_, (400, 5), jnp.float32)).T.copy()
    eps2 = np.asarray(jax.random.normal(k2_, (idx.size, 5), jnp.float32)).T.copy()
    out = tit.pathwise_predict(
        tf, params_from_jax(p0), torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(y),
        torch.from_numpy(test_idx.astype(np.int64)), num_samples=5,
        settings=tit.CGSettings(**SETTINGS), mask=torch.from_numpy(mask),
        eps1=torch.from_numpy(eps1), eps2=torch.from_numpy(eps2),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-4)
    summary = tit.summarize_samples(out)
    assert summary.mean.shape == (test_idx.size,) and bool((summary.var > 0).all())


def test_full_space_fit_requires_distinct_ids(stencil_pair):
    _, tf, _ = stencil_pair
    idx = torch.tensor([1, 2, 2, 3])
    with pytest.raises(ValueError, match="distinct"):
        tit.fit(tf, idx, torch.zeros(4), full_space=True, num_steps=1)


def test_fit_matches_jax_after_a_few_steps(stencil_pair):
    jf, tf, y_all = stencil_pair
    idx, y, mask = _padded_obs(y_all, seed=2)
    p0 = _params(2)
    key = jax.random.PRNGKey(5)
    js = jit_.CGSettings(**SETTINGS)
    steps = 3
    ref = jit_.fit(jf, jnp.asarray(idx), jnp.asarray(y), kind="free", key=key,
                   init={k: jnp.asarray(v) for k, v in p0.items()}, learning_rate=0.05,
                   num_steps=steps, settings=js, mask=jnp.asarray(mask))
    _, k_loop = jax.random.split(key)
    probes = np.stack([
        np.asarray(jlin.rademacher_probes(k, idx.size, js.num_probes)).T
        for k in jax.random.split(k_loop, steps)
    ])
    out = tit.fit(tf, torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(y),
                  init=params_from_jax(p0), learning_rate=0.05, num_steps=steps,
                  settings=tit.CGSettings(**SETTINGS), mask=torch.from_numpy(mask),
                  probes=torch.from_numpy(probes))
    # Adam's steps are lr·sign-like, so agreement is set by the step size
    # times the gradients' relative error: 1e-3 absolute after 3 steps.
    for k in p0:
        np.testing.assert_allclose(out.params[k].numpy(), np.asarray(ref.params[k]),
                                   rtol=0, atol=1e-3)
    np.testing.assert_allclose(out.losses.numpy(), np.asarray(ref.losses), rtol=RTOL)


def test_params_diffusion_kind_matches_jax():
    from graphgp_tpu.gp import params as jparams

    pj = jparams.init_params("diffusion", 5, jax.random.PRNGKey(0), noise=0.2, beta=1.5,
                             sigma_f=0.7)
    pt = tparams.init_params("diffusion", 5, noise=0.2, beta=1.5, sigma_f=0.7)
    for k in pj:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6)
    np.testing.assert_allclose(tparams.modulator("diffusion", pt, 5).numpy(),
                               np.asarray(jparams.modulator("diffusion", pj, 5)), rtol=1e-5)
    np.testing.assert_allclose(float(tparams.noise_variance(pt)),
                               float(jparams.noise_variance(pj)), rtol=1e-6)
    with pytest.raises(ValueError):
        params_from_jax({"bogus": np.zeros(1)})


# ---------------------------------------------------------------------------
# The train block against the full-graph products it replaces in the fits.
# K_tt from the block and the full-graph Gram matvec differ in float32
# summation order alone: 1e-5 of max |ref| on one product, as the ELL
# products' tests take it. Through the solves of mll_cg (tol 1e-6) that
# rounding is amplified a little: rtol 1e-4 on values and gradients, as the
# parity tests above.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block_layouts(stencil_pair):
    """A periodic stencil ring (wraparound offsets live) and the grid."""
    from graphgp_tpu_torch.data import synthetic
    from graphgp_tpu_torch.features import stencil_is_periodic
    from graphgp_tpu_torch.preprocessor import preprocess_graph
    from graphgp_tpu_torch.walker import WalkConfig

    ring = synthetic.generate("ring", 120, seed=0)
    rf = preprocess_graph(ring["adjacency"], WalkConfig(64, 0.1, 4), seed=1, layout="auto",
                          device="cpu")
    assert isinstance(rf, StencilFeatures) and stencil_is_periodic(rf.mats)
    _, gf, y_grid = stencil_pair
    return {"ring": (rf, ring["y_observed"].astype(np.float32)), "grid": (gf, y_grid)}


def _slots(y_all, masked, seed=0):
    """Masked: padded slots repeat node 0 with y 0, and one observation
    repeats another. Unmasked: 30 slots with one repeated observation."""
    if masked:
        idx, y, mask = _padded_obs(y_all, seed=seed)
        return torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(y), torch.from_numpy(mask)
    rng = np.random.default_rng(seed)
    idx = rng.choice(y_all.size, 30, replace=False)
    idx[5] = idx[3]
    return torch.from_numpy(idx), torch.from_numpy(y_all[idx]), None


def _rel_close(got, ref, rel=1e-5):
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= rel * scale


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("graph", ["ring", "grid"])
def test_train_block_gram_matvec_equals_full_graph(block_layouts, graph, masked):
    feats, y_all = block_layouts[graph]
    idx, _, mask = _slots(y_all, masked)
    f = torch.from_numpy(_params()["modulator"])
    nv = torch.tensor(0.2)
    v = torch.from_numpy(np.random.default_rng(3).normal(size=(5, idx.numel())).astype(np.float32))
    block = tit.build_train_block(feats, idx)
    got = tit.make_gram_matvec_block()((block.k_tt(f), nv, mask), v)
    phi = contract(feats, f)
    ref = tit.make_gram_matvec_bm()((phi, nv, idx, mask), v)
    _rel_close(got, ref)


@pytest.mark.parametrize("builder", ["block", "full_graph"])
def test_a_mask_of_ones_gives_the_unmasked_operator(block_layouts, builder):
    """The masked Gram form under a mask of ones is the unmasked one, bit
    for bit: ``M v`` is v and ``(I − M) v`` adds zeros."""
    feats, y_all = block_layouts["grid"]
    idx, _, _ = _slots(y_all, False)
    f = torch.from_numpy(_params()["modulator"])
    nv = torch.tensor(0.2)
    v = torch.from_numpy(np.random.default_rng(4).normal(size=(5, idx.numel())).astype(np.float32))
    ones = torch.ones(idx.numel())
    if builder == "block":
        matvec = tit.make_gram_matvec_block()
        head = (tit.build_train_block(feats, idx).k_tt(f), nv)
    else:
        matvec = tit.make_gram_matvec_bm()
        head = (contract(feats, f), nv, idx)
    got = matvec((*head, ones), v)
    assert torch.equal(got, matvec((*head, None), v))
    # a 1-D v is one row
    assert torch.equal(matvec((*head, ones), v[0]), matvec((*head, ones), v[:1])[0])


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("graph", ["ring", "grid"])
def test_mll_cg_on_the_train_block_equals_full_graph(block_layouts, graph, masked, monkeypatch):
    feats, y_all = block_layouts[graph]
    idx, y, mask = _slots(y_all, masked, seed=1)
    probes = tlin.rademacher_probes(idx.numel(), 8, torch.Generator().manual_seed(3))
    settings = tit.CGSettings(**SETTINGS)

    def run():
        p = {k: v.requires_grad_(True) for k, v in params_from_jax(_params(1)).items()}
        val = tit.mll_cg(feats, p, idx, y, settings=settings, mask=mask,
                         num_real=None if mask is None else float(mask.sum()), probes=probes)
        val.backward()
        return val.detach(), {k: v.grad for k, v in p.items()}

    assert tit.build_train_block(feats, idx) is not None
    val, grads = run()
    monkeypatch.setattr(tit, "TRAIN_BLOCK_BUDGET", 0)
    assert tit.build_train_block(feats, idx) is None
    ref_val, ref_grads = run()
    np.testing.assert_allclose(float(val), float(ref_val), rtol=RTOL)
    for k in ("modulator", "raw_noise"):
        np.testing.assert_allclose(grads[k].numpy(), ref_grads[k].numpy(), rtol=RTOL, atol=1e-4)
    assert torch.all(grads["modulator"] != 0)


@pytest.mark.parametrize("graph", ["ring", "grid"])
def test_two_train_block_builds_are_bit_identical(block_layouts, graph):
    feats, y_all = block_layouts[graph]
    idx, _, _ = _slots(y_all, True)
    a, b = tit.build_train_block(feats, idx), tit.build_train_block(feats, idx)
    assert a.gram.shape == (4, idx.numel(), 4, idx.numel())
    assert torch.equal(a.gram, b.gram)


def _dense_gram(feats, idx):
    """``G[l, a, m, b]`` in float64 from every slot's dense train rows."""
    cols, vals = step_rows(feats, idx)
    l, t, k = vals.shape
    rows = np.zeros((l, t, feats.num_target_nodes))
    np.add.at(rows, (np.arange(l)[:, None, None], np.arange(t)[None, :, None],
                     np.broadcast_to(cols.numpy(), (l, t, k))), vals.double().numpy())
    rows = rows.reshape(l * t, -1)
    return torch.from_numpy(rows @ rows.T).view(l, t, l, t)


@pytest.mark.parametrize("slots", ["padded", "node_0_live", "unmasked"])
@pytest.mark.parametrize("graph", ["ring", "grid"])
def test_the_sparse_block_equals_a_float64_dense_gram(block_layouts, graph, slots):
    """Padded slots at node 0 (and a live observation of node 0 among
    them), a repeated live node, or no padding: each slot reads its node's
    rows, whichever slot of the node was built."""
    feats, y_all = block_layouts[graph]
    idx, _, _ = _slots(y_all, slots != "unmasked")
    if slots == "node_0_live":
        idx[7] = 0
    got = tit.build_train_block(feats, idx).gram.double()
    ref = _dense_gram(feats, idx)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def _pairs(feats, idx):
    """Pairs of live train-row entries of the distinct nodes of ``idx`` that
    share a column (an entry pairs with itself too), counted on the host."""
    cols, vals = step_rows(feats, torch.unique(idx))
    cols = np.broadcast_to(cols.numpy(), vals.shape)[vals.numpy() != 0]
    return int((np.bincount(cols).astype(np.int64) ** 2).sum())


def test_a_block_over_the_budget_takes_the_full_graph_path(block_layouts, monkeypatch):
    """The budget counts the bytes of the block's (L·T)² Gram matrix, held
    three times, and of the pairs of train-row entries it sums, which padded
    slots do not multiply."""
    feats, y_all = block_layouts["grid"]
    idx, y, mask = _slots(y_all, True)
    lt = feats.max_walk_length * idx.numel()
    need = 12 * lt * lt + tit.PAIR_BYTES * _pairs(feats, idx)
    monkeypatch.setattr(tit, "TRAIN_BLOCK_BUDGET", need)
    assert tit.build_train_block(feats, idx) is not None
    monkeypatch.setattr(tit, "TRAIN_BLOCK_BUDGET", need - 1)
    assert tit.build_train_block(feats, idx) is None
    calls = []
    monkeypatch.setattr(tit, "make_gram_matvec_block", lambda: calls.append(1))
    tit.mll_cg(feats, params_from_jax(_params()), idx, y, settings=tit.CGSettings(**SETTINGS),
               mask=mask, num_real=30.0, generator=torch.Generator().manual_seed(0))
    assert calls == []



# ---------------------------------------------------------------------------
# The draws' compact residual solve on the train block against the same draw
# on full-graph products (the budget at 0 refuses every block): the same ε,
# the same operator up to float32 summation order inside K_tt. At the cells'
# tolerance (1e-2) CG stops while float32 rounding still steers its iterates
# (the two solutions differ by ~2e-4 of their largest entry), and the
# correction K*,t amplifies that, so the samples are compared at 1e-6, where
# the solves have converged; at both tolerances each solve is held to its
# true float64 residual, as the benchmark's draw_drift check holds it.
# ---------------------------------------------------------------------------


def _recorded_draw(feats, idx, y, mask, tol=1e-2):
    """A pathwise draw at every node under fixed ε; the recorder's counts
    inside its ``gp.predict`` span; and its solve, ``(b, CGResult)``."""
    from graphgp_tpu_torch.utils import profiling

    eps1 = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, feats.num_target_nodes)).astype(np.float32))
    eps2 = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, idx.numel())).astype(np.float32))
    solves, original = [], tit.batched_cg

    def captured(matvec, carry, b, **kwargs):
        out = original(matvec, carry, b, **kwargs)
        solves.append((b, out))
        return out

    tit.batched_cg = captured
    profiling.reset()
    profiling.enable()
    try:
        out = tit.pathwise_predict(
            feats, params_from_jax(_params(2)), idx, y, torch.arange(feats.num_nodes),
            num_samples=4, settings=tit.CGSettings(cg_tol=tol, cg_max_iters=300), mask=mask,
            eps1=eps1, eps2=eps2)
        (predict,) = [s for s in profiling.snapshot()["spans"] if s["name"] == "gp.predict"]
    finally:
        tit.batched_cg = original
        profiling.disable()
        profiling.reset()
    (solve,) = solves
    return out, predict["counts"], solve


def _true_residual(feats, idx, mask, solve):
    """‖b − Ã x‖ / ‖b‖ of a draw's compact solve in float64, Ã the masked
    operator from every slot's dense train rows (repeated slots add up)."""
    from graphgp_tpu_torch.gp import params as tparams

    b, res = solve
    p = params_from_jax(_params(2))
    f = tparams.modulator("free", p, feats.max_walk_length).double()
    k = torch.einsum("l,lamb,m->ab", f, _dense_gram(feats, idx), f)
    m = torch.ones(idx.numel(), dtype=torch.float64) if mask is None else mask.double()
    a = m[:, None] * k * m[None, :] + torch.diag(
        float(tparams.noise_variance(p)) * m + (1 - m))
    b = b.double()
    return torch.linalg.vector_norm(b - res.x.double() @ a, dim=-1) / \
        torch.linalg.vector_norm(b, dim=-1)


@pytest.mark.parametrize("tol", [1e-2, 1e-6])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("graph", ["ring", "grid"])
def test_a_draw_on_the_train_block_equals_the_full_graph_draw(block_layouts, graph, masked, tol,
                                                             monkeypatch):
    """Padded slots at node 0 and a repeated train node (masked), or a
    repeated node alone: the two solves take the same CG iterations, or one
    more or less, each reports its true residual, and converged draws agree
    within 1e-5 of the largest sample."""
    feats, y_all = block_layouts[graph]
    idx, y, mask = _slots(y_all, masked, seed=2)
    got, on_block, block_solve = _recorded_draw(feats, idx, y, mask, tol)
    assert on_block["gram.train_block"] > 0 and "gram.full_graph" not in on_block
    monkeypatch.setattr(tit, "TRAIN_BLOCK_BUDGET", 0)
    ref, on_graph, graph_solve = _recorded_draw(feats, idx, y, mask, tol)
    assert on_graph["gram.full_graph"] > 0 and "gram.train_block" not in on_graph
    assert abs(on_block["cg.iterations"] - on_graph["cg.iterations"]) <= 1
    for solve in (block_solve, graph_solve):
        drift = _true_residual(feats, idx, mask, solve) - solve[1].residual_norm.double()
        assert float(drift.abs().max()) <= 1e-5
    if tol <= 1e-6:
        _rel_close(got, ref)


@pytest.mark.parametrize("spare", [0, -1], ids=["at_the_budget", "over_the_budget"])
def test_a_draw_over_the_budget_takes_the_full_graph_path(block_layouts, spare, monkeypatch):
    """The draw's block is held to the fits' budget: one byte over it and
    every Gram product of the draw's solve is a full-graph one: one an
    iteration, none at the solve's zero start."""
    feats, y_all = block_layouts["grid"]
    idx, y, mask = _slots(y_all, True)
    lt = feats.max_walk_length * idx.numel()
    need = 12 * lt * lt + tit.PAIR_BYTES * _pairs(feats, idx)
    monkeypatch.setattr(tit, "TRAIN_BLOCK_BUDGET", need + spare)
    _, counts, _ = _recorded_draw(feats, idx, y, mask)
    products = counts["cg.iterations"]
    if spare == 0:
        assert counts["gram.train_block"] == products and "gram.full_graph" not in counts
    else:
        assert counts["gram.full_graph"] == products and "gram.train_block" not in counts
