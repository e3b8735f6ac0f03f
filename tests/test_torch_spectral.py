"""``gp/spectral.py``, the ``exact_diffusion`` kind and ``params.describe``
against the JAX package, on the CPU.

The eigenbasis is carried across with ``eigenbasis_from_numpy``: eigenvector
signs (and the basis inside a repeated eigenvalue, which a grid has) are
free, so two ``eigh`` calls need not agree, while everything downstream is a
function of one decomposition. Tolerances: ``mll`` and ``predict`` go through
a float32 Cholesky of a few dozen rows (rtol 1e-4); five Adam steps compound
the gradients' differences (rtol 1e-3 on the losses); the feature products
are single float32 matrix products (1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgp_tpu.data import synthetic as jsynthetic
from graphgp_tpu.gp import params as jparams
from graphgp_tpu.gp import spectral as jspectral
from graphgp_tpu_torch.convert import eigenbasis_from_numpy, params_from_jax
from graphgp_tpu_torch.gp import exact as texact
from graphgp_tpu_torch.gp import params as tparams
from graphgp_tpu_torch.gp import spectral as tspectral

N = 64


@pytest.fixture(scope="module")
def setup():
    data = jsynthetic.generate("grid", N, seed=2)
    jeig = jspectral.eigenbasis(data["adjacency"])
    teig = eigenbasis_from_numpy(np.asarray(jeig.evals), np.asarray(jeig.evecs))
    perm = np.random.default_rng(0).permutation(N)
    y = data["y_observed"].astype(np.float32)
    return dict(adj=data["adjacency"], jeig=jeig, teig=teig, y=y,
                tr=np.sort(perm[:40]).astype(np.int32), te=np.sort(perm[40:]).astype(np.int32))


def _p0(noise=-1.5, beta=0.3, sigma=0.8):
    return {"raw_noise": np.float32(noise), "raw_beta": np.float32(beta),
            "raw_sigma_f": np.float32(sigma)}


def _jp(p0):
    return {k: jnp.asarray(v) for k, v in p0.items()}


def _idx(a):
    return torch.from_numpy(a.astype(np.int64))


def test_eigenbasis_reassembles_the_laplacian(setup):
    """The port's own ``eigh``: eigenvalues match the JAX package's, and
    Q diag(λ) Qᵀ is the Laplacian (the vectors themselves are free)."""
    eig = tspectral.eigenbasis(setup["adj"], device="cpu")
    np.testing.assert_allclose(eig.evals.numpy(), np.asarray(setup["jeig"].evals), atol=2e-5)
    from graphgp_tpu_torch.graphs import normalized_laplacian

    lap = normalized_laplacian(setup["adj"].toarray())
    np.testing.assert_allclose(((eig.evecs * eig.evals[None, :]) @ eig.evecs.T).numpy(),
                               lap.numpy(), atol=2e-5)
    assert eig.evals.dtype == torch.float32 and eig.evecs.shape == (N, N)


def test_eigenbasis_from_numpy_checks_shapes():
    with pytest.raises(ValueError, match="do not match"):
        eigenbasis_from_numpy(np.zeros(3), np.zeros((4, 4)))


def test_init_params_match_jax():
    want = jspectral.init_params(noise=0.3, beta=2.0, sigma_f=1.5)
    got = tspectral.init_params(noise=0.3, beta=2.0, sigma_f=1.5)
    assert set(got) == set(want) == {"raw_noise", "raw_beta", "raw_sigma_f"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


@pytest.mark.parametrize("p0", [_p0(), _p0(-3.0, 1.2, 0.1)], ids=["a", "b"])
def test_mll_value_and_gradient_match_jax(setup, p0):
    tr, y = setup["tr"], setup["y"]
    val_j, g_j = jax.value_and_grad(
        lambda p: jspectral.mll(setup["jeig"], p, jnp.asarray(tr), jnp.asarray(y[tr])))(_jp(p0))
    p = {k: v.requires_grad_(True) for k, v in params_from_jax(p0).items()}
    val = tspectral.mll(setup["teig"], p, _idx(tr), torch.from_numpy(y[tr]))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(val_j), rtol=1e-4)
    for k in p0:
        np.testing.assert_allclose(float(p[k].grad), float(g_j[k]), rtol=1e-3, atol=1e-3)


def test_predict_matches_jax(setup):
    p0 = _p0()
    tr, te, y = setup["tr"], setup["te"], setup["y"]
    ref = jspectral.predict(setup["jeig"], _jp(p0), jnp.asarray(tr), jnp.asarray(y[tr]),
                            jnp.asarray(te))
    post = tspectral.predict(setup["teig"], params_from_jax(p0), _idx(tr), torch.from_numpy(y[tr]),
                             _idx(te))
    np.testing.assert_allclose(post.mean.numpy(), np.asarray(ref.mean), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(post.var.numpy(), np.asarray(ref.var), rtol=1e-4, atol=1e-5)
    assert isinstance(post, texact.Posterior)


def test_fit_adam_losses_match_jax(setup):
    p0 = _p0()
    tr, y = setup["tr"], setup["y"]
    ref = jspectral.fit(setup["jeig"], jnp.asarray(tr), jnp.asarray(y[tr]), init=_jp(p0),
                        learning_rate=0.05, num_steps=5)
    out = tspectral.fit(setup["teig"], _idx(tr), torch.from_numpy(y[tr]), init=params_from_jax(p0),
                        learning_rate=0.05, num_steps=5)
    # losses[i] is the loss before step i, as the JAX scan returns it
    first = -tspectral.mll(setup["teig"], params_from_jax(p0), _idx(tr), torch.from_numpy(y[tr]))
    assert float(out.losses[0]) == pytest.approx(float(first), rel=1e-6)
    np.testing.assert_allclose(out.losses.numpy(), np.asarray(ref.losses), rtol=1e-3)
    for k in p0:
        np.testing.assert_allclose(float(out.params[k]), float(ref.params[k]), rtol=0, atol=1e-3)
        assert not out.params[k].requires_grad


def test_fit_default_init_lowers_the_loss(setup):
    tr, y = setup["tr"], setup["y"]
    out = tspectral.fit(setup["teig"], _idx(tr), torch.from_numpy(y[tr]), num_steps=30)
    losses = out.losses.numpy()
    assert losses.shape == (30,) and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert tspectral.fit(setup["teig"], _idx(tr), torch.from_numpy(y[tr]),
                         num_steps=0).losses.shape == (0,)


def test_spectral_features_products_match_jax(setup):
    jf = jspectral.SpectralDiffusionFeatures(setup["jeig"])
    tf = tspectral.SpectralDiffusionFeatures(setup["teig"])
    f = np.asarray([1.3, 0.7], np.float32)  # the (β, σ_f) pair
    rng = np.random.default_rng(5)
    v = rng.normal(size=(3, N)).astype(np.float32)
    idx = np.asarray([0, 5, 17, 63])
    pairs = [
        (tf.rows(f, _idx(idx)), jf.rows(jnp.asarray(f), jnp.asarray(idx))),
        (tf.matvec(f, torch.from_numpy(v.T.copy())), jf.matvec(jnp.asarray(f), jnp.asarray(v.T))),
        (tf.rmatvec(f, torch.from_numpy(v.T.copy())), jf.rmatvec(jnp.asarray(f), jnp.asarray(v.T))),
        (tf.matvec_bm(f, torch.from_numpy(v)), jf.matvec_bm(jnp.asarray(f), jnp.asarray(v))),
        (tf.rmatvec_bm(f, torch.from_numpy(v)), jf.rmatvec_bm(jnp.asarray(f), jnp.asarray(v))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (tf.num_nodes, tf.num_target_nodes, tf.max_walk_length) == (N, N, 2)
    # K = ΦΦᵀ is σ_f² expm(−βL) exactly
    from graphgp_tpu_torch.kernels import diffusion_kernel

    phi = tf.rows(f, torch.arange(N))
    np.testing.assert_allclose((phi @ phi.T).numpy(),
                               (0.7**2 * diffusion_kernel(setup["adj"], beta=1.3, device="cpu")).numpy(),
                               atol=2e-5)


def test_exact_diffusion_kind_through_the_exact_gp(setup):
    """``kind='exact_diffusion'`` hands (β, σ_f) to the spectral layout: the
    generic exact GP over SpectralDiffusionFeatures is the spectral GP."""
    p0 = _p0()
    tr, y = setup["tr"], setup["y"]
    feats = tspectral.SpectralDiffusionFeatures(setup["teig"])
    p = params_from_jax(p0)
    a = texact.mll(feats, p, _idx(tr), torch.from_numpy(y[tr]), kind="exact_diffusion")
    b = tspectral.mll(setup["teig"], p, _idx(tr), torch.from_numpy(y[tr]))
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    want = jparams.modulator("exact_diffusion", _jp(p0), 2)
    got = tparams.modulator("exact_diffusion", p, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_exact_diffusion_init_and_unknown_kind():
    want = jparams.init_params("exact_diffusion", 2, jax.random.PRNGKey(0), noise=0.2, beta=3.0)
    got = tparams.init_params("exact_diffusion", 2, noise=0.2, beta=3.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    for fn in (lambda: tparams.init_params("matern", 3),
               lambda: tparams.modulator("matern", got, 3)):
        with pytest.raises(ValueError, match="exact_diffusion"):
            fn()


@pytest.mark.parametrize("kind", ["free", "diffusion", "exact_diffusion"])
def test_describe_matches_jax(kind):
    if kind == "free":
        p0 = {"raw_noise": np.float32(-2.0), "modulator": np.asarray([0.5, -1.0, 2.0], np.float32)}
    else:
        p0 = _p0()
    want = jparams.describe(kind, _jp(p0), 3)
    got = tparams.describe(kind, params_from_jax(p0), 3)
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], float)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
