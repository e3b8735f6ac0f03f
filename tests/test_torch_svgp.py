"""``gp/svgp`` against ``graphgp_tpu/gp/svgp.py`` on the CPU, at a small size
(a 120-node community graph, C = 3 classes, M = 20 inducing nodes, 80
train, 40 test).

Both packages get the same features (``convert.dense_from_numpy`` of the
JAX walks, ``convert.eigenbasis_from_numpy`` of its eigenbasis), the same
parameters (``convert.svgp_params_from_jax``, q(u) moved off its initial
value) and, for the softmax likelihood, the same ``eps``. Tolerances,
relative to the largest reference entry: posterior and ELBO 1e-4 (float32
Cholesky and triangular solves from two libraries), gradients 1e-3, class
probabilities 1e-5 absolute; 30 Adam steps of ``fit`` from the same start
1e-3. JAX is imported inside the tests, so the ``gpu`` test runs without it:
    python -m pytest --noconftest -m gpu -q tests/test_torch_svgp.py
"""
import numpy as np
import pytest
import torch

from graphgp_tpu_torch import convert
from graphgp_tpu_torch.cli.classification import synthetic_community_graph
from graphgp_tpu_torch.gp import spectral, svgp

N, C, M, L = 120, 3, 20, 4
KINDS = ("free", "diffusion", "exact_diffusion")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch work on one intra-op thread: its ops are small, and
    beside other test processes threads that wait by spinning make them many
    times slower (the thread count is restored after the file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def problem():
    adj, labels = synthetic_community_graph(N, C, seed=0, p_in=0.15, p_out=0.01)
    rng = np.random.default_rng(0)
    perm = rng.permutation(N)
    tr, te = np.sort(perm[:80]), np.sort(perm[80:])
    inducing = np.sort(rng.choice(tr, M, replace=False))
    return {"adj": adj, "labels": labels.astype(np.int64), "tr": tr, "te": te,
            "inducing": inducing, "y_real": rng.normal(size=N).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_features(problem):
    import jax

    from graphgp_tpu.gp import spectral as jspectral
    from graphgp_tpu.kernels import features_for_adjacency

    dense = features_for_adjacency(problem["adj"], jax.random.PRNGKey(42), walks_per_node=64,
                                   p_halt=0.1, max_walk_length=L)
    return {"dense": dense, "spectral": jspectral.SpectralDiffusionFeatures(
        jspectral.eigenbasis(problem["adj"]))}


def _features(jax_features, kind):
    """(JAX features, port features) of a kind."""
    if kind == "exact_diffusion":
        jf = jax_features["spectral"]
        return jf, spectral.SpectralDiffusionFeatures(
            convert.eigenbasis_from_numpy(np.asarray(jf.eig.evals), np.asarray(jf.eig.evecs)))
    jf = jax_features["dense"]
    return jf, convert.dense_from_numpy(np.asarray(jf.step_matrices))


def _params(kind, seed=1):
    """JAX parameters with q(u) moved off its start: (jax dict, port dict)."""
    import jax
    import jax.numpy as jnp

    from graphgp_tpu.gp import svgp as jsvgp

    jp = jsvgp.init_variational(jax.random.PRNGKey(seed), kind, L, M, C)
    rng = np.random.default_rng(seed)
    jp["q_mu"] = jnp.asarray(rng.normal(size=(M, C)), jnp.float32)
    tri = np.tril(0.1 * rng.normal(size=(C, M, M)), -1) + np.eye(M) * rng.uniform(0.5, 1.0, (C, M, 1))
    jp["q_sqrt"] = jnp.asarray(tri, jnp.float32)
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    return jp, convert.svgp_params_from_jax(np_params)


def _idx(a):
    return torch.from_numpy(np.asarray(a, np.int64))


@pytest.mark.parametrize("kind", KINDS)
def test_latent_posterior_matches_jax(problem, jax_features, kind):
    import jax.numpy as jnp

    from graphgp_tpu.gp import svgp as jsvgp

    jf, tf = _features(jax_features, kind)
    jp, tp = _params(kind)
    for x in ("te", "tr"):
        ref = jsvgp._latent_posterior(jf, jp, jnp.asarray(problem["inducing"], jnp.int32),
                                      jnp.asarray(problem[x], jnp.int32), kind)
        ours = svgp._latent_posterior(tf, tp, _idx(problem["inducing"]), _idx(problem[x]), kind)
        assert ours.mean.shape == (problem[x].size, C)
        assert _rel(ours.mean, ref.mean) <= 1e-4, (x, _rel(ours.mean, ref.mean))
        assert _rel(ours.var, ref.var) <= 1e-4, (x, _rel(ours.var, ref.var))


@pytest.mark.parametrize("likelihood", ["robustmax", "softmax", "gaussian"])
@pytest.mark.parametrize("kind", KINDS)
def test_elbo_and_its_gradients_match_jax(problem, jax_features, kind, likelihood):
    import jax
    import jax.numpy as jnp

    from graphgp_tpu.gp import svgp as jsvgp

    jf, tf = _features(jax_features, kind)
    jp, tp = _params(kind)
    tr = problem["tr"]
    y = problem["y_real"][tr] if likelihood == "gaussian" else problem["labels"][tr]
    key = jax.random.PRNGKey(5)
    jy = jnp.asarray(y)

    def jelbo(p):
        return jsvgp.elbo(jf, p, jnp.asarray(problem["inducing"], jnp.int32),
                          jnp.asarray(tr, jnp.int32), jy, key, kind=kind, likelihood=likelihood)

    ref, ref_grad = jax.value_and_grad(jelbo)(jp)
    # the draws the JAX elbo makes from its key, handed to the port
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (8, tr.size, C), jnp.float32)))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    ours = svgp.elbo(tf, tp, _idx(problem["inducing"]), _idx(tr), torch.from_numpy(y), kind=kind,
                     likelihood=likelihood, eps=eps)
    ours.backward()
    assert abs(float(ours.detach()) - float(ref)) <= 1e-4 * abs(float(ref))
    scale = max(float(np.abs(np.asarray(g)).max()) for g in ref_grad.values())
    for k in tp:
        # a parameter the likelihood does not read (raw_noise but for the
        # gaussian one) gets no gradient here and a zero one in JAX
        grad = torch.zeros_like(tp[k]) if tp[k].grad is None else tp[k].grad
        if not np.any(np.asarray(ref_grad[k])):
            assert not grad.any(), k
        elif likelihood == "robustmax" and k == "raw_sigma_f":
            # σ_f scales every latent alike and the argmax does not see a
            # scale: this gradient is 0 but for the 1e-5 jitter, a sum that
            # cancels to rounding, so it is held against the gradient's scale
            for g in (grad.numpy(), np.asarray(ref_grad[k])):
                assert abs(float(g)) <= 1e-3 * scale, (k, float(g), scale)
            assert abs(float(grad) - float(ref_grad[k])) <= 1e-3 * scale
        else:
            assert _rel(grad, ref_grad[k]) <= 1e-3, (k, _rel(grad, ref_grad[k]))


@pytest.mark.parametrize("kind", KINDS)
def test_class_probabilities_and_predictions_match_jax(problem, jax_features, kind):
    import jax
    import jax.numpy as jnp

    from graphgp_tpu.gp import svgp as jsvgp

    jf, tf = _features(jax_features, kind)
    jp, tp = _params(kind, seed=2)
    ji, jt = jnp.asarray(problem["inducing"], jnp.int32), jnp.asarray(problem["te"], jnp.int32)
    ti, tt = _idx(problem["inducing"]), _idx(problem["te"])
    ref = np.asarray(jsvgp.predict_class_probs(jf, jp, ji, jt, jax.random.PRNGKey(0), kind=kind,
                                               likelihood="robustmax"))
    ours = svgp.predict_class_probs(tf, tp, ti, tt, kind=kind, likelihood="robustmax").numpy()
    assert ours.shape == (problem["te"].size, C)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    assert clear.sum() > 0.5 * clear.size
    for likelihood in ("robustmax", "softmax"):
        pj = np.asarray(jsvgp.predict_class(jf, jp, ji, jt, kind=kind, likelihood=likelihood))
        pt = svgp.predict_class(tf, tp, ti, tt, kind=kind, likelihood=likelihood).numpy()
        keep = clear if likelihood == "robustmax" else np.ones_like(clear)
        np.testing.assert_array_equal(pt[keep], pj[keep])


def test_softmax_class_probabilities_match_jax_with_its_draws(problem, jax_features):
    import jax
    import jax.numpy as jnp

    from graphgp_tpu.gp import svgp as jsvgp

    jf, tf = _features(jax_features, "free")
    jp, tp = _params("free")
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jsvgp.predict_class_probs(
        jf, jp, jnp.asarray(problem["inducing"], jnp.int32), jnp.asarray(problem["te"], jnp.int32),
        key, kind="free", num_samples=16, likelihood="softmax"))
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (16, problem["te"].size, C))))
    ours = svgp.predict_class_probs(tf, tp, _idx(problem["inducing"]), _idx(problem["te"]),
                                    kind="free", num_samples=16, likelihood="softmax", eps=eps)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_init_and_kl_of_the_start_match_jax():
    import jax

    from graphgp_tpu.gp import svgp as jsvgp

    jp = jsvgp.init_variational(jax.random.PRNGKey(0), "diffusion", L, M, C)
    tp = svgp.init_variational("diffusion", L, M, C)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert float(svgp._kl_whitened(tp)) == pytest.approx(float(jsvgp._kl_whitened(jp)), abs=1e-6)
    np.testing.assert_array_equal(svgp._gh_nodes(20)[0].numpy(), np.asarray(jsvgp._gh_nodes(20)[0]))


@pytest.mark.parametrize("kind", ["free", "exact_diffusion"])
def test_fit_from_the_same_start_matches_jax(problem, jax_features, kind):
    """30 Adam steps at the protocol's learning rate on the robustmax ELBO (no
    draws in the loop) from the JAX fit's own initial parameters."""
    import jax
    import jax.numpy as jnp

    from graphgp_tpu.gp import svgp as jsvgp

    jf, tf = _features(jax_features, kind)
    key = jax.random.PRNGKey(42)
    ji = jnp.asarray(problem["inducing"], jnp.int32)
    jtr, jte = jnp.asarray(problem["tr"], jnp.int32), jnp.asarray(problem["te"], jnp.int32)
    y = problem["labels"]
    ref = jsvgp.fit(jf, ji, jtr, jnp.asarray(y[problem["tr"]], jnp.int32), num_latent=C,
                    kind=kind, likelihood="robustmax", key=key, learning_rate=3e-3, num_steps=30)
    k_init, _ = jax.random.split(key)
    start = jsvgp.init_variational(k_init, kind, jf.max_walk_length, M, C)
    init = convert.svgp_params_from_jax({k: np.asarray(v) for k, v in start.items()})
    ti, tte = _idx(problem["inducing"]), _idx(problem["te"])
    ours = svgp.fit(tf, ti, _idx(problem["tr"]), torch.from_numpy(y[problem["tr"]]),
                    num_latent=C, kind=kind, likelihood="robustmax", init=init,
                    learning_rate=3e-3, num_steps=30)
    np.testing.assert_allclose(ours.losses.numpy(), np.asarray(ref.losses), rtol=1e-3)
    assert float(ours.losses[-1]) < float(ours.losses[0])
    pj = np.asarray(jsvgp.predict_class(jf, ref.params, ji, jte, kind=kind, likelihood="robustmax"))
    pt = svgp.predict_class(tf, ours.params, ti, tte, kind=kind, likelihood="robustmax").numpy()
    np.testing.assert_array_equal(pt, pj)


def test_fit_draws_come_from_the_generator(problem):
    """The softmax likelihood's draws each step: the same generator seed gives
    the same losses, another seed others."""
    feats = spectral.SpectralDiffusionFeatures(spectral.eigenbasis(problem["adj"], device="cpu"))
    args = (feats, _idx(problem["inducing"]), _idx(problem["tr"]),
            torch.from_numpy(problem["labels"][problem["tr"]]))
    runs = [svgp.fit(*args, num_latent=C, kind="exact_diffusion", likelihood="softmax",
                     num_steps=3, generator=torch.Generator().manual_seed(s)) for s in (4, 4, 5)]
    assert torch.equal(runs[0].losses, runs[1].losses)
    assert not torch.equal(runs[0].losses, runs[2].losses)


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_latent_posterior_and_elbo_on_the_card_equal_the_cpu(problem):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from graphgp_tpu_torch.kernels import features_for_adjacency

    cpu = features_for_adjacency(problem["adj"], 42, walks_per_node=64, p_halt=0.1,
                                 max_walk_length=L, device="cpu")
    card = convert.dense_from_numpy(cpu.step_matrices.numpy(), device="cuda")
    params = svgp.init_variational("free", L, M, C, generator=torch.Generator().manual_seed(0))
    params["q_mu"] = torch.randn((M, C), generator=torch.Generator().manual_seed(1))
    args = (_idx(problem["inducing"]), _idx(problem["tr"]))
    y = torch.from_numpy(problem["labels"][problem["tr"]])
    post_c = svgp._latent_posterior(cpu, params, *args, "free")
    gpu_params = {k: v.cuda() for k, v in params.items()}
    post_g = svgp._latent_posterior(card, gpu_params, *(a.cuda() for a in args), "free")
    assert _rel(post_g.mean.cpu(), post_c.mean) <= 1e-4
    assert _rel(post_g.var.cpu(), post_c.var) <= 1e-4
    e_c = svgp.elbo(cpu, params, *args, y, kind="free", likelihood="robustmax")
    e_g = svgp.elbo(card, gpu_params, *(a.cuda() for a in args), y.cuda(), kind="free",
                    likelihood="robustmax")
    assert abs(float(e_g) - float(e_c)) <= 1e-4 * abs(float(e_c))
