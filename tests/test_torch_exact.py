"""The dense regime of the scaling experiment's exact arm against the JAX
package: dense step matrices, ``ell_to_dense``, the Cholesky helpers and
``gp/exact`` (``mll``, its gradient, ``predict``, ``fit``).

Tolerances: walks are bit-identical, so dense step matrices differ only by
the order of the scatter-add (1e-6); ``mll`` and ``predict`` go through a
float32 Cholesky of a few hundred rows (rtol 1e-4); five Adam steps compound
the gradients' differences (rtol 1e-3 on the losses). ``torch.optim.LBFGS``
and optax's L-BFGS take different line searches, so L-BFGS is held only to a
non-increasing loss.
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
from graphgp_tpu.data.synthetic import generate_ring_data
from graphgp_tpu.gp import exact as jexact
from graphgp_tpu_torch import features as tfeat
from graphgp_tpu_torch import graphs as tgraphs
from graphgp_tpu_torch import linalg as tlin
from graphgp_tpu_torch import walker as twalker
from graphgp_tpu_torch.convert import dense_from_numpy, ell_from_numpy, params_from_jax
from graphgp_tpu_torch.gp import exact as texact

N = 128
CFG = dict(walks_per_node=40, p_halt=0.1, max_walk_length=3)


@pytest.fixture(scope="module")
def ring():
    data = generate_ring_data(N, seed=3)
    jm = jwalker.sample_dense_step_matrices(
        jgraphs.pack_laplacian(data["adjacency"]), jax.random.PRNGKey(7), jwalker.WalkConfig(**CFG))
    rng = np.random.default_rng(0)
    perm = rng.permutation(N)
    return dict(
        data=data, jfeats=jfeat.DenseFeatures(jm), tfeats=dense_from_numpy(np.asarray(jm)),
        tr=np.sort(perm[: N // 2]).astype(np.int32), te=np.sort(perm[N // 2:]).astype(np.int32),
        y=data["y_observed"].astype(np.float32),
    )


def _p0(seed=0):
    rng = np.random.default_rng(seed)
    return {"raw_noise": np.float32(-2.0), "modulator": rng.normal(size=3).astype(np.float32)}


def _jp(p0):
    return {k: jnp.asarray(v) for k, v in p0.items()}


def _idx(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("graph", ["ring", "grid"])
def test_dense_step_matrices_match_jax(graph):
    from graphgp_tpu.data.synthetic import generate

    adj = generate(graph, 64 if graph == "ring" else 49, seed=1)["adjacency"]
    ref = jwalker.sample_dense_step_matrices(
        jgraphs.pack_laplacian(adj), jax.random.PRNGKey(5), jwalker.WalkConfig(**CFG))
    got = twalker.sample_dense_step_matrices(
        tgraphs.pack_laplacian(adj), 5, twalker.WalkConfig(**CFG))
    assert got.shape == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    # step 0 is the identity: every walk starts at its node with load 1
    np.testing.assert_allclose(got[0].numpy(), np.eye(got.shape[1]), atol=1e-6)


def test_dense_step_matrices_rectangular_target():
    log = twalker.sample_walk_log(
        tgraphs.pack_laplacian(generate_ring_data(32)["adjacency"]), 0, twalker.WalkConfig(**CFG),
        node_offset=8, num_start_nodes=5)
    m = twalker.dense_step_matrices(log, twalker.WalkConfig(**CFG), num_target_nodes=32)
    assert m.shape == (3, 5, 32)
    np.testing.assert_allclose(m[0, :, 8:13].numpy(), np.eye(5), atol=1e-6)


def test_ell_to_dense_is_exact():
    adj = generate_ring_data(48, seed=2)["adjacency"]
    log = jwalker.sample_walk_log(jgraphs.pack_laplacian(adj), jax.random.PRNGKey(2),
                                  jwalker.WalkConfig(**CFG))
    jm = jfeat.consolidate(log, jfeat.suggest_row_capacity(log))
    ref = jfeat.ell_to_dense(jm)
    got = tfeat.ell_to_dense(ell_from_numpy(np.asarray(jm.cols), np.asarray(jm.vals), 48))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # and the ELL matrices are the dense sampler's, up to summation order
    dense = twalker.dense_step_matrices(
        twalker.sample_walk_log(tgraphs.pack_laplacian(adj), 2, twalker.WalkConfig(**CFG)),
        twalker.WalkConfig(**CFG))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-6)


def test_cholesky_helpers_match_jax():
    rng = np.random.default_rng(4)
    m = rng.normal(size=(30, 30)).astype(np.float32)
    a = m @ m.T + 0.5 * np.eye(30, dtype=np.float32)
    b = rng.normal(size=30).astype(np.float32)
    chol_j = jlin.safe_cholesky(jnp.asarray(a), jitter=1e-6)
    chol_t = tlin.safe_cholesky(torch.from_numpy(a), jitter=1e-6)
    np.testing.assert_allclose(chol_t.numpy(), np.asarray(chol_j), rtol=1e-4, atol=1e-5)
    x_t = tlin.cholesky_solve(chol_t, torch.from_numpy(b))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(jlin.cholesky_solve(chol_j, jnp.asarray(b))),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(a @ x_t.numpy(), b, atol=1e-3)
    cols = tlin.cholesky_solve(chol_t, torch.from_numpy(np.stack([b, 2 * b], axis=1)))
    np.testing.assert_allclose(cols[:, 1].numpy(), 2 * x_t.numpy(), rtol=1e-4, atol=1e-5)


def test_dense_features_products_match_jax(ring):
    f = np.asarray([0.9, -0.4, 0.2], np.float32)
    v = np.random.default_rng(5).normal(size=(3, N)).astype(np.float32)
    jf, tf = ring["jfeats"], ring["tfeats"]
    np.testing.assert_allclose(tf.phi(f).numpy(), np.asarray(jf.phi(f)), atol=1e-6)
    np.testing.assert_allclose(tf.matvec_bm(f, torch.from_numpy(v)).numpy(),
                               np.asarray(jf.matvec_bm(f, jnp.asarray(v))), atol=1e-5)
    np.testing.assert_allclose(tf.rmatvec_bm(f, torch.from_numpy(v)).numpy(),
                               np.asarray(jf.rmatvec_bm(f, jnp.asarray(v))), atol=1e-5)
    np.testing.assert_allclose(tf.matvec(f, torch.from_numpy(v.T.copy())).numpy(),
                               np.asarray(jf.matvec(f, jnp.asarray(v.T))), atol=1e-5)
    np.testing.assert_allclose(tf.rows(f, _idx(ring["tr"])).numpy(),
                               np.asarray(jf.rows(f, jnp.asarray(ring["tr"]))), atol=1e-6)
    assert (tf.num_nodes, tf.num_target_nodes, tf.max_walk_length) == (N, N, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_mll_value_and_gradient_match_jax(ring, seed):
    p0 = _p0(seed)
    tr, y = ring["tr"], ring["y"]
    val_j, g_j = jax.value_and_grad(
        lambda p: jexact.mll(ring["jfeats"], p, jnp.asarray(tr), jnp.asarray(y[tr])))(_jp(p0))
    p = {k: v.requires_grad_(True) for k, v in params_from_jax(p0).items()}
    val = texact.mll(ring["tfeats"], p, _idx(tr), torch.from_numpy(y[tr]))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(val_j), rtol=1e-4)
    for k in p0:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(g_j[k]), rtol=1e-4, atol=1e-3)


def test_predict_mean_and_variance_match_jax(ring):
    p0 = _p0(2)
    tr, te, y = ring["tr"], ring["te"], ring["y"]
    ref = jexact.predict(ring["jfeats"], _jp(p0), jnp.asarray(tr), jnp.asarray(y[tr]),
                         jnp.asarray(te))
    p = params_from_jax(p0)
    post = texact.predict(ring["tfeats"], p, _idx(tr), torch.from_numpy(y[tr]), _idx(te))
    np.testing.assert_allclose(post.mean.numpy(), np.asarray(ref.mean), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(post.var.numpy(), np.asarray(ref.var), rtol=1e-4, atol=1e-5)
    y_te = y[te]
    np.testing.assert_allclose(float(texact.nlpd(post, p, torch.from_numpy(y_te))),
                               float(jexact.nlpd(ref, _jp(p0), jnp.asarray(y_te))), rtol=1e-4)
    np.testing.assert_allclose(float(texact.rmse(post, torch.from_numpy(y_te))),
                               float(jexact.rmse(ref, jnp.asarray(y_te))), rtol=1e-4)


@pytest.mark.parametrize("prior", [None, (np.log(0.01), 0.5)], ids=["mle", "noise-prior"])
def test_fit_adam_losses_match_jax(ring, prior):
    p0 = _p0(3)
    tr, y = ring["tr"], ring["y"]
    ref = jexact.fit(ring["jfeats"], jnp.asarray(tr), jnp.asarray(y[tr]), init=_jp(p0),
                     learning_rate=0.05, num_steps=5, optimizer="adam",
                     noise_prior_lognormal=prior)
    out = texact.fit(ring["tfeats"], _idx(tr), torch.from_numpy(y[tr]), init=params_from_jax(p0),
                     learning_rate=0.05, num_steps=5, optimizer="adam",
                     noise_prior_lognormal=prior)
    np.testing.assert_allclose(out.losses.numpy(), np.asarray(ref.losses), rtol=1e-3)
    for k in p0:
        np.testing.assert_allclose(out.params[k].numpy(), np.asarray(ref.params[k]),
                                   rtol=0, atol=1e-3)


def test_fit_lbfgs_loss_never_increases(ring):
    tr, y = ring["tr"], ring["y"]
    out = texact.fit(ring["tfeats"], _idx(tr), torch.from_numpy(y[tr]),
                     init=params_from_jax(_p0(3)), num_steps=12, optimizer="lbfgs")
    losses = out.losses.numpy()
    assert losses.shape == (12,) and np.isfinite(losses).all()
    assert np.all(np.diff(losses) <= 1e-4 * np.abs(losses[:-1]))
    assert losses[-1] < losses[0]
    for v in out.params.values():
        assert bool(torch.isfinite(v).all()) and not v.requires_grad
    with pytest.raises(ValueError, match="optimizer"):
        texact.fit(ring["tfeats"], _idx(tr), torch.from_numpy(y[tr]), optimizer="sgd")
