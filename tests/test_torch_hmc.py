"""``gp/hmc`` and ``cli/hmc`` against ``graphgp_tpu/gp/hmc.py`` and
``graphgp_tpu/cli/hmc.py`` on the CPU, and the ``safe_cholesky`` repair.

The problem is the JAX driver test's (``test_hmc_driver_small``): a 60-node
circle, walks_per_node 100, L 3, the CLI's split, the diffusion kernel. Both
packages get the JAX walks' dense step matrices. JAX's random draws cannot be
reproduced by torch, so each sampler run here builds JAX's draws from JAX's
key tree (``split(key, C)``; each chain key → ``k_init, k_run``;
``split(k_run, T)``; each step key → ``k_mom, k_acc``) and hands them to
both packages.

Tolerances, relative to the largest reference entry: the log posterior and
its gradient 1e-5 (a float32 Cholesky of 30 rows in two libraries); the
leapfrog 1e-5; sampler trajectories under shared draws 1e-4, with every
accept decision equal and at least 1e-3 from its threshold (f32 rounding
could flip a decision closer than that, after which the chains part for
good: such a decision is reported, not hidden); the Laplace covariance 1e-3
(a float32 Hessian); the refined −logp 1e-3 (two L-BFGS line searches);
the CLI's point RMSE 1e-3 (200 Adam steps in two libraries).

Trajectory parity holds where float32 rounding is not amplified, and the
runs here are chosen for that. Dual averaging feeds each acceptance
probability back into the step size (×20·√t/(t+10)); a trajectory that
goes unstable (ε too large for a stiff direction) ends at a large energy
whose float32 rounding, 1e-5 of it, moves its acceptance probability by
1e-2 nats; and at each mass-window boundary μ restarts at log(10·ε), so the
next trajectory runs at up to 10× the step size. Measured between the
packages (3 chains, 6 leapfrog steps): on the 3-d Gaussian 1e-5 through the
first boundary, 5e-4 two iterations after it; on the raw GP posterior 2e-5
after 2 + 2 iterations, 5e-4 after 4 + 4, 4e-3 after 8 + 8; at a fixed step
size (no warmup) 6e-7 after 20 iterations. So the sampler is held in
parts: dual averaging and the sampling phase on the Gaussian (warmup 8,
below JAX's 20 for mass windows); the windows' Welford estimate, shrinkage
and restart through the first boundary and the first trajectory under the
new mass; and 20 iterations at the CLI's step size on the GP posterior, raw
and Laplace-whitened.
"""
import math

import numpy as np
import pytest
import torch

from graphgp_tpu_torch import convert, linalg
from graphgp_tpu_torch.gp import exact, hmc

N_NODES, WPN, L = 60, 100, 3
DRIVER_ARGV = ["--graph-type", "circle", "--n-nodes", "60", "--walks-per-node", "100",
               "--max-walk-length", "3", "--num-chains", "2", "--num-warmup", "40",
               "--num-samples", "40", "--num-leapfrog", "6"]
PREC = np.asarray([[2.0, 0.5, 0.0], [0.5, 1.5, 0.3], [0.0, 0.3, 1.0]], np.float32)
ANCHOR_STD = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch work on one intra-op thread (small ops beside other
    test processes); restored after the file."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_draws(key_seed, num_chains, total, dim):
    """JAX's draws of ``hmc.sample(..., PRNGKey(key_seed))`` as HMCDraws."""
    import jax

    def one(chain_key):
        k_init, k_run = jax.random.split(chain_key)

        def step(step_key):
            k_mom, k_acc = jax.random.split(step_key)
            return jax.random.normal(k_mom, (dim,)), jax.random.uniform(k_acc, ())

        mom, u = jax.vmap(step)(jax.random.split(k_run, total))
        return jax.random.normal(k_init, (dim,)), mom, u

    init, mom, u = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(key_seed), num_chains))
    return hmc.HMCDraws(_t(init), _t(mom), _t(u))


@pytest.fixture(scope="module")
def problem():
    """The driver test's features, split and targets; the JAX ML-II fit and
    its refined mode; both packages' log posteriors."""
    import jax
    import jax.numpy as jnp

    from graphgp_tpu.data import synthetic
    from graphgp_tpu.gp import exact as jexact
    from graphgp_tpu.gp import hmc as jhmc
    from graphgp_tpu.kernels import features_for_adjacency

    data = synthetic.generate("circle", N_NODES, seed=0)
    perm = np.random.default_rng(0).permutation(N_NODES)
    tr = np.sort(perm[: N_NODES // 2]).astype(np.int32)
    te = np.sort(perm[N_NODES // 2:]).astype(np.int32)
    y = np.asarray(data["y_observed"], np.float32)
    jfeats = features_for_adjacency(data["adjacency"], jax.random.PRNGKey(42),
                                    walks_per_node=WPN, p_halt=0.1, max_walk_length=L)
    jfit = jexact.fit(jfeats, jnp.asarray(tr), jnp.asarray(y[tr]), kind="diffusion",
                      num_steps=200)
    anchor = float(jfit.params["raw_noise"])
    jlog_post = jhmc.make_gp_log_posterior(
        lambda q: jexact.mll(jfeats, q, jnp.asarray(tr), jnp.asarray(y[tr]), kind="diffusion"),
        prior_std=2.0, anchors={"raw_noise": (anchor, ANCHOR_STD)})
    tfeats = convert.dense_from_numpy(np.asarray(jfeats.step_matrices))
    tr_t, y_t = torch.from_numpy(tr.astype(np.int64)), torch.from_numpy(y)
    tlog_post = hmc.make_gp_log_posterior(
        lambda q: exact.mll(tfeats, q, tr_t, y_t[tr_t], kind="diffusion"),
        prior_std=2.0, anchors={"raw_noise": (anchor, ANCHOR_STD)})
    fit_np = {k: np.asarray(v) for k, v in jfit.params.items()}
    return dict(jlog_post=jlog_post, tlog_post=tlog_post, fit=fit_np, tfeats=tfeats,
                tr=tr_t, y=y_t)


def _gaussian_targets():
    import jax.numpy as jnp

    prec_j, prec_t = jnp.asarray(PREC), torch.from_numpy(PREC)
    return (lambda p: -0.5 * p["x"] @ prec_j @ p["x"],
            lambda p: -0.5 * p["x"] @ prec_t @ p["x"],
            {"x": np.zeros(3, np.float32)})


def _assert_runs_agree(jres, tres, draws, label):
    """Equal accept decisions, each at least 1e-3 from its threshold, and
    trajectories to rel 1e-4."""
    u = draws.uniform.numpy().astype(np.float64)
    a_j = np.asarray(jres.accept_trace, np.float64)
    a_t = tres.accept_trace.numpy().astype(np.float64)
    with np.errstate(divide="ignore"):
        log_acc = np.log(a_j)
    margin = np.abs(np.log(u) - log_acc)
    close = np.argwhere(margin < 1e-3)
    assert close.size == 0, (
        f"{label}: accept decisions within 1e-3 of their threshold (chain, iteration): "
        f"{close.tolist()}, margins {margin[margin < 1e-3].tolist()}")
    with np.errstate(divide="ignore"):
        np.testing.assert_array_equal(np.log(u) < np.log(a_t), np.log(u) < log_acc)
    for name in jres.samples:
        assert _rel(tres.samples[name].numpy(), jres.samples[name]) <= 1e-4, (label, name)
    for field in ("log_probs", "eps_trace", "accept_trace", "step_size", "accept_rate"):
        ref = np.asarray(getattr(jres, field))
        got = getattr(tres, field).numpy()
        assert got.shape == ref.shape, (label, field)
        assert _rel(got, ref) <= 1e-4, (label, field, _rel(got, ref))


# ---------------------------------------------------------------------------
# The safe_cholesky repair
# ---------------------------------------------------------------------------


BAD_MATRICES = {
    "indefinite": [[1.0, 2.0], [2.0, 1.0]],
    "inf off the diagonal": [[2.0, np.inf], [np.inf, 2.0]],
    "inf in the trailing diagonal": [[1.0, 0.0], [0.0, np.inf]],
    "nan": [[np.nan, 0.0], [0.0, 1.0]],
}


@pytest.mark.parametrize("name", sorted(BAD_MATRICES))
def test_safe_cholesky_gives_jax_nan_pattern(name):
    """Where the matrix is not positive definite the factor is NaN on and
    below the diagonal, as jnp.linalg.cholesky's, instead of a raise."""
    import jax.numpy as jnp

    from graphgp_tpu import linalg as jlinalg

    a = np.asarray(BAD_MATRICES[name], np.float32)
    ref = np.asarray(jlinalg.safe_cholesky(jnp.asarray(a)))
    got = linalg.safe_cholesky(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))
    ok = np.isfinite(ref)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-6)
    # batched: each matrix on its own
    batch = torch.stack([torch.from_numpy(a), torch.eye(2) * 4.0])
    out = linalg.safe_cholesky(batch)
    np.testing.assert_array_equal(np.isnan(out[0].numpy()), np.isnan(ref))
    np.testing.assert_allclose(out[1].numpy(), np.eye(2) * 2.0, rtol=1e-6)


@pytest.mark.parametrize("modulator", [[np.inf, 0.0, 0.0], [3e19, 1.0, 0.0], [np.nan, 1.0, 0.0]])
def test_exact_mll_non_finite_like_jax(problem, modulator):
    """exact.mll on parameters whose Gram matrix is not positive definite
    returns JAX's non-finite value instead of raising."""
    import jax.numpy as jnp

    from graphgp_tpu.features import DenseFeatures
    from graphgp_tpu.gp import exact as jexact

    params = {"raw_noise": np.float32(-2.0), "modulator": np.asarray(modulator, np.float32)}
    jfeats = DenseFeatures(jnp.asarray(problem["tfeats"].step_matrices.numpy()))
    tr, y = problem["tr"], problem["y"][problem["tr"]]
    ref = float(jexact.mll(jfeats, {k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(tr.numpy()), jnp.asarray(y.numpy()), kind="free"))
    got = float(exact.mll(problem["tfeats"], convert.params_from_jax(params), tr, y, kind="free"))
    assert not math.isfinite(ref)
    assert math.isnan(got) == math.isnan(ref) and (got == ref or math.isnan(got)), (got, ref)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 50, 3), (3, 41), (2, 40, 2, 2)])
def test_split_rhat_matches_jax(shape):
    import jax.numpy as jnp

    from graphgp_tpu.gp import hmc as jhmc

    x = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32)
    x[0] += 0.5  # one chain off the others
    ref = np.asarray(jhmc.split_rhat(jnp.asarray(x)))
    got = hmc.split_rhat(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    tree = hmc.split_rhat_tree({"b": torch.from_numpy(x), "a": torch.from_numpy(2 * x)})
    assert list(tree) == ["a", "b"]


def test_gp_log_posterior_value_and_gradient_match_jax(problem):
    import jax
    import jax.numpy as jnp

    params = {k: v + np.float32(0.1) for k, v in problem["fit"].items()}
    ref_v, ref_g = jax.value_and_grad(problem["jlog_post"])(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    val = problem["tlog_post"](tp)
    grads = torch.autograd.grad(val, list(tp.values()))
    assert abs(float(val) - float(ref_v)) <= 1e-5 * abs(float(ref_v))
    got_g = np.array([float(g) for g in grads])
    want_g = np.array([float(ref_g[k]) for k in tp])
    assert _rel(got_g, want_g) <= 1e-5, (got_g, want_g)


def test_leapfrog_matches_jax(problem):
    import jax
    import jax.numpy as jnp

    from graphgp_tpu.gp import hmc as jhmc

    q0, spec = hmc._flatten(problem["fit"])
    jq0, jspec = jhmc._flatten({k: jnp.asarray(v) for k, v in problem["fit"].items()})
    np.testing.assert_array_equal(q0.numpy(), np.asarray(jq0))  # same (sorted) order
    p0 = np.random.default_rng(0).normal(size=q0.shape[0]).astype(np.float32)
    inv_mass = np.asarray([0.5, 1.0, 2.0], np.float32)
    jgrad = jax.grad(lambda q: problem["jlog_post"](jhmc._unflatten(q, jspec)))
    jq, jp = jhmc._leapfrog(jgrad, jq0, jnp.asarray(p0), 0.05, 8, jnp.asarray(inv_mass))
    tgrad = torch.func.grad(lambda q: problem["tlog_post"](hmc._unflatten(q, spec)))
    tq, tp = hmc._leapfrog(tgrad, q0, torch.from_numpy(p0), 0.05, 8, torch.from_numpy(inv_mass))
    assert _rel(tq.numpy(), jq) <= 1e-5
    assert _rel(tp.numpy(), jp) <= 1e-5


# ---------------------------------------------------------------------------
# The sampler under JAX's draws
# ---------------------------------------------------------------------------


# dual averaging through warmup, then sampling; no mass windows (warmup < 20)
SHORT = dict(num_warmup=8, num_samples=8, num_leapfrog=6, initial_step_size=0.1)
# the sampling phase alone, at the CLI's step size
FIXED = dict(num_warmup=0, num_samples=20, num_leapfrog=6, initial_step_size=0.1)
# mass windows at iterations 5, 10 and 15
WINDOWED = dict(num_warmup=20, num_samples=4, num_leapfrog=6, initial_step_size=0.1)
# the first boundary and the first trajectory under its mass
WINDOW_PREFIX = WINDOWED["num_warmup"] // 4 + 1


def _targets(problem, target):
    if target == "gaussian":
        jlp, tlp, init = _gaussian_targets()
        return jlp, tlp, init, {k: torch.from_numpy(v) for k, v in init.items()}
    init = problem["fit"]
    return problem["jlog_post"], problem["tlog_post"], init, convert.params_from_jax(init)


def _both_runs(problem, target, cfg_kw, chains=3, key_seed=0):
    import jax
    import jax.numpy as jnp

    from graphgp_tpu.gp import hmc as jhmc

    jlp, tlp, init, tinit = _targets(problem, target)
    total = cfg_kw["num_warmup"] + cfg_kw["num_samples"]
    jres = jhmc.sample(jlp, {k: jnp.asarray(v) for k, v in init.items()},
                       jax.random.PRNGKey(key_seed), config=jhmc.HMCConfig(**cfg_kw),
                       num_chains=chains)
    draws = _jax_draws(key_seed, chains, total, sum(np.size(v) for v in init.values()))
    tres = hmc.sample(tlp, tinit, config=hmc.HMCConfig(**cfg_kw), num_chains=chains, draws=draws)
    return jres, tres, draws


@pytest.mark.parametrize("target, cfg_kw", [("gaussian", SHORT), ("gp", FIXED)],
                         ids=["gaussian-adapting", "gp-fixed-step"])
def test_sample_under_jax_draws_matches_jax(problem, target, cfg_kw):
    """Dual averaging through warmup, then the sampling phase (accept counts
    after warmup only), on the 3-d Gaussian of the JAX sharded-chains test;
    20 iterations on the GP posterior at the CLI's step size."""
    jres, tres, draws = _both_runs(problem, target, cfg_kw)
    _assert_runs_agree(jres, tres, draws, target)


@pytest.mark.parametrize("target", ["gaussian"])
def test_mass_windows_match_jax(problem, target):
    """The windowed mass adaptation: Welford over the first window, the
    shrunk and floored variance as the new mass, dual averaging restarted
    around the current ε (ε jumps ~10× at the boundary), and the first
    trajectory under the new mass, against JAX under its draws."""
    jres, tres, draws = _both_runs(problem, target, WINDOWED)
    k = WINDOW_PREFIX
    eps_j = np.asarray(jres.eps_trace)[:, :k]
    acc_j = np.asarray(jres.accept_trace)[:, :k]
    assert _rel(tres.eps_trace[:, :k].numpy(), eps_j) <= 1e-4
    assert _rel(tres.accept_trace[:, :k].numpy(), acc_j) <= 1e-4
    # the boundary's restart: μ = log(10 ε), so ε grows several-fold
    assert (eps_j[:, k - 2] > 3 * eps_j[:, k - 3]).all(), eps_j
    u = np.log(draws.uniform[:, :k].numpy().astype(np.float64))
    with np.errstate(divide="ignore"):
        log_acc = np.log(acc_j.astype(np.float64))
        np.testing.assert_array_equal(u < np.log(tres.accept_trace[:, :k].numpy()), u < log_acc)
    assert np.abs(u - log_acc).min() >= 1e-3


def test_generator_draws_repeat_and_pad_for_ranks():
    """Without explicit draws the run is a function of the generator's seed."""
    _, tlp, init = _gaussian_targets()
    init = {k: torch.from_numpy(v) for k, v in init.items()}
    cfg = hmc.HMCConfig(num_warmup=20, num_samples=10, num_leapfrog=4)
    a = hmc.sample(tlp, init, torch.Generator().manual_seed(3), config=cfg, num_chains=2)
    b = hmc.sample(tlp, init, torch.Generator().manual_seed(3), config=cfg, num_chains=2)
    torch.testing.assert_close(a.samples["x"], b.samples["x"], rtol=0, atol=0)
    assert a.samples["x"].shape == (2, 10, 3) and a.eps_trace.shape == (2, 30)
    with pytest.raises(ValueError, match="draws have shapes"):
        hmc.sample(tlp, init, config=cfg, num_chains=2, draws=hmc.draw(3, 30, 3))


def test_step_jitter_draws_come_last_and_scale_each_step():
    """Jitter's scales are drawn after everything else (the other draws are
    those of a run without it); a scale of 1 is the fixed step bit for bit;
    a chain's constant scale c runs as initial_step_size · c; jitter with
    explicit draws that carry no scales raises."""
    _, tlp, init = _gaussian_targets()
    init = {k: torch.from_numpy(v) for k, v in init.items()}
    plain = hmc.draw(3, 20, 3, torch.Generator().manual_seed(5))
    jit = hmc.draw(3, 20, 3, torch.Generator().manual_seed(5), step_jitter=0.2)
    assert plain.step_scale is None
    for a, b in zip(plain[:3], jit[:3]):
        assert torch.equal(a, b)
    assert jit.step_scale.shape == (3, 20)
    assert bool(((jit.step_scale >= 0.8) & (jit.step_scale <= 1.2)).all())

    cfg = hmc.HMCConfig(**FIXED)
    ref = hmc.sample(tlp, init, config=cfg, num_chains=3, draws=plain)
    ones = hmc.sample(tlp, init, config=cfg, num_chains=3,
                      draws=plain._replace(step_scale=torch.ones(3, 20)))
    torch.testing.assert_close(ones.samples["x"], ref.samples["x"], rtol=0, atol=0)
    c = torch.tensor([0.5, 1.0, 3.0])
    scaled = hmc.sample(tlp, init, config=cfg, num_chains=3,
                        draws=plain._replace(step_scale=c[:, None].expand(3, 20)))
    for i in range(3):
        one = hmc.sample(tlp, init, num_chains=1, draws=hmc.HMCDraws(*(d[i:i + 1] for d in plain[:3])),
                         config=hmc.HMCConfig(**{**FIXED, "initial_step_size": 0.1 * float(c[i])}))
        assert _rel(scaled.samples["x"][i].numpy(), one.samples["x"][0].numpy()) <= 1e-5, i
    with pytest.raises(ValueError, match="step_scale"):
        hmc.sample(tlp, init, config=hmc.HMCConfig(**FIXED, step_jitter=0.1), num_chains=3,
                   draws=plain)


@pytest.mark.parametrize("jitter", [0.0, 0.2])
def test_jittered_chains_recover_the_target(jitter):
    """The step jitter keeps the target: the JAX sharded-chains test's
    moments, R-hat and accept bounds on the 3-d Gaussian, 8 chains."""
    _, tlp, init = _gaussian_targets()
    init = {k: torch.from_numpy(v) for k, v in init.items()}
    cfg = hmc.HMCConfig(num_warmup=200, num_samples=600, num_leapfrog=8, step_jitter=jitter)
    res = hmc.sample(tlp, init, torch.Generator().manual_seed(0), config=cfg, num_chains=8)
    x = res.samples["x"].reshape(-1, 3).numpy()
    np.testing.assert_allclose(x.mean(0), np.zeros(3), atol=0.12)
    np.testing.assert_allclose(np.cov(x.T), np.linalg.inv(PREC), atol=0.15)
    assert (hmc.split_rhat_tree(res.samples)["x"] < 1.1).all()
    assert (res.accept_rate > 0.5).all()


def test_non_finite_energy_is_a_rejection():
    """A trajectory that leaves the support (its log density NaN, here a
    Cholesky of an indefinite matrix) is rejected, and the chain goes on."""
    def log_prob(p):
        x = p["x"]
        a = torch.stack([torch.stack([torch.ones_like(x[0]), x[0]]),
                         torch.stack([x[0], torch.ones_like(x[0])])])
        chol = linalg.safe_cholesky(a, jitter=0.0)  # NaN once |x0| ≥ 1
        return 2.0 * torch.log(torch.diagonal(chol)).sum() - 8.0 * (x ** 2).sum()

    cfg = hmc.HMCConfig(num_warmup=20, num_samples=40, num_leapfrog=8, initial_step_size=2.0)
    res = hmc.sample(log_prob, {"x": torch.zeros(2)}, torch.Generator().manual_seed(0),
                     config=cfg, num_chains=3)
    assert torch.isfinite(res.samples["x"]).all()
    assert (res.samples["x"][..., 0].abs() < 1).all()
    assert torch.isfinite(res.log_probs).all()
    assert (res.accept_trace == 0).any()  # some trajectories diverged
    assert torch.isfinite(res.step_size).all() and (res.step_size > 0).all()


# ---------------------------------------------------------------------------
# Mode refinement and the Laplace whitening
# ---------------------------------------------------------------------------


def test_refine_mode_descends_and_matches_jax(problem):
    import jax.numpy as jnp

    from graphgp_tpu.gp import hmc as jhmc

    jmode, jtrace = jhmc.refine_mode(problem["jlog_post"],
                                     {k: jnp.asarray(v) for k, v in problem["fit"].items()})
    mode, trace = hmc.refine_mode(problem["tlog_post"], convert.params_from_jax(problem["fit"]))
    assert trace.shape == (100,)
    assert float(trace[-1]) <= float(trace[0])
    final = -float(problem["tlog_post"](mode))
    ref = -float(problem["jlog_post"](jmode))
    assert final <= float(trace[0])
    assert abs(final - ref) <= 1e-3 * abs(ref), (final, ref)


def _jax_whitening(problem):
    """The JAX package's sample_laplace whitening lines, at the JAX fit."""
    import jax
    import jax.numpy as jnp

    from graphgp_tpu.gp import hmc as jhmc

    flat0, spec = jhmc._flatten({k: jnp.asarray(v) for k, v in problem["fit"].items()})
    h = jax.hessian(lambda q: problem["jlog_post"](jhmc._unflatten(q, spec)))(flat0)
    evals, evecs = jnp.linalg.eigh(-0.5 * (h + h.T))
    evals = jnp.maximum(evals, jnp.maximum(1e-4 * jnp.max(evals), 1e-10))
    return np.asarray(flat0), np.asarray(evecs * (1.0 / jnp.sqrt(evals))[None, :])


def test_laplace_clipped_covariance_matches_jax(problem):
    flat0_j, sqrt_j = _jax_whitening(problem)
    flat0, sqrt_cov, _ = hmc.laplace_whitening(problem["tlog_post"],
                                               convert.params_from_jax(problem["fit"]))
    np.testing.assert_array_equal(flat0.numpy(), flat0_j)
    cov = (sqrt_cov @ sqrt_cov.T).numpy()
    assert _rel(cov, sqrt_j @ sqrt_j.T) <= 1e-3


def test_whitened_sampler_matches_jax_and_maps_back(problem):
    """HMC on a log_prob_z built from the JAX whitening matrix, under JAX's
    draws, in both packages; and sample_laplace maps its z-samples back
    through its own whitening."""
    import jax
    import jax.numpy as jnp

    from graphgp_tpu.gp import hmc as jhmc

    flat0_j, sqrt_j = _jax_whitening(problem)
    _, jspec = jhmc._flatten({k: jnp.asarray(v) for k, v in problem["fit"].items()})
    _, tspec = hmc._flatten(convert.params_from_jax(problem["fit"]))
    f0, s0 = jnp.asarray(flat0_j), jnp.asarray(sqrt_j)
    jz = lambda zp: problem["jlog_post"](jhmc._unflatten(f0 + s0 @ zp["z"], jspec))
    tz = lambda zp: problem["tlog_post"](hmc._unflatten(_t(flat0_j) + _t(sqrt_j) @ zp["z"], tspec))
    chains, total = 2, FIXED["num_warmup"] + FIXED["num_samples"]
    jres = jhmc.sample(jz, {"z": jnp.zeros(3, jnp.float32)}, jax.random.PRNGKey(1),
                       config=jhmc.HMCConfig(**FIXED), num_chains=chains)
    draws = _jax_draws(1, chains, total, 3)
    tres = hmc.sample(tz, {"z": torch.zeros(3)}, config=hmc.HMCConfig(**FIXED),
                      num_chains=chains, draws=draws)
    _assert_runs_agree(jres, tres, draws, "whitened GP posterior")

    mode = convert.params_from_jax(problem["fit"])
    lap = hmc.sample_laplace(problem["tlog_post"], mode, config=hmc.HMCConfig(**FIXED),
                             num_chains=chains, draws=draws)
    flat0, sqrt_cov, spec = hmc.laplace_whitening(problem["tlog_post"], mode)
    zlp = lambda zp: problem["tlog_post"](hmc._unflatten(flat0 + sqrt_cov @ zp["z"], spec))
    zres = hmc.sample(zlp, {"z": torch.zeros(3)}, config=hmc.HMCConfig(**FIXED), num_chains=chains,
                      draws=draws)
    want = hmc._unflatten(flat0 + torch.einsum("ij,csj->csi", sqrt_cov, zres.samples["z"]), spec)
    for k in want:
        torch.testing.assert_close(lap.samples[k], want[k], rtol=0, atol=0)
    torch.testing.assert_close(lap.log_probs, zres.log_probs, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


def test_hmc_cli_matches_jax_driver(tmp_path):
    """The JAX driver test's argv through both CLIs: the same record names,
    the JAX test's assertions, and the ML-II point RMSE to rel 1e-3."""
    from graphgp_tpu.cli.hmc import main as jmain
    from graphgp_tpu_torch.cli.hmc import main

    ref = jmain([*DRIVER_ARGV, "--results-dir", str(tmp_path / "jax")])
    records = main([*DRIVER_ARGV, "--device", "cpu", "--results-dir", str(tmp_path / "torch")])
    assert [r["quantity"] for r in records] == [r["quantity"] for r in ref]
    by_name = {r["quantity"]: r["value"] for r in records}
    ref_by = {r["quantity"]: r["value"] for r in ref}
    assert by_name["accept_chain0"] > 0.2
    assert np.isfinite(by_name["bayes_nlpd"])
    assert by_name["beta_std"] > 0
    assert abs(by_name["point_rmse"] - ref_by["point_rmse"]) <= 1e-3 * ref_by["point_rmse"]
    assert (tmp_path / "torch" / "hmc.csv").exists()


def test_hmc_cli_flags_are_jax_plus_device_and_step_jitter(tmp_path):
    """Every JAX flag with its default; the port adds --device and
    --step-jitter (default 0.1; 0 is the JAX sampler's fixed step), and the
    CLI hands the jitter to the sampler."""
    import json

    from graphgp_tpu.cli.hmc import main as jmain
    from graphgp_tpu_torch.cli import hmc as hmc_cli

    jmain([*DRIVER_ARGV, "--num-warmup", "0", "--num-samples", "4", "--results-dir",
           str(tmp_path / "jax")])
    ref = json.loads((tmp_path / "jax" / "hmc_config.json").read_text())
    ours = vars(hmc_cli.build_parser().parse_args(
        [*DRIVER_ARGV, "--num-warmup", "0", "--num-samples", "4", "--results-dir",
         str(tmp_path / "jax")]))
    assert set(ours) - set(ref) == {"device", "step_jitter"} and set(ref) <= set(ours)
    assert {k: ours[k] for k in ref} == ref
    assert hmc_cli.build_parser().parse_args([]).step_jitter == 0.1

    seen = []
    sample_laplace = hmc.sample_laplace
    try:
        hmc.sample_laplace = lambda *a, **kw: seen.append(kw["config"]) or sample_laplace(*a, **kw)
        for jitter in ("0", "0.2"):
            hmc_cli.main([*DRIVER_ARGV, "--num-warmup", "0", "--num-samples", "4", "--device",
                          "cpu", "--step-jitter", jitter, "--results-dir", str(tmp_path / "t")])
    finally:
        hmc.sample_laplace = sample_laplace
    assert [c.step_jitter for c in seen] == [0.0, 0.2]


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_batched_cholesky_nan_pattern_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mats = torch.tensor([BAD_MATRICES[k] for k in sorted(BAD_MATRICES)]
                        + [[[4.0, 0.0], [0.0, 9.0]]])
    got = linalg.safe_cholesky(mats.cuda()).cpu()
    ref = linalg.safe_cholesky(mats)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref.numpy()))
    torch.testing.assert_close(got[-1], ref[-1])


@pytest.mark.gpu
def test_sampler_on_the_card_equals_the_cpu():
    """The Gaussian target, the same draws, card against CPU at a fixed step
    (no warmup: dual averaging would amplify the two libraries' float32
    rounding, as between JAX and this package), every accept decision
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prec = torch.from_numpy(PREC)
    cfg = hmc.HMCConfig(**FIXED)
    draws = hmc.draw(4, FIXED["num_warmup"] + FIXED["num_samples"], 3,
                     torch.Generator().manual_seed(0))
    cpu = hmc.sample(lambda p: -0.5 * p["x"] @ prec @ p["x"], {"x": torch.zeros(3)},
                     config=cfg, num_chains=4, draws=draws)
    prec_g = prec.cuda()
    card = hmc.sample(lambda p: -0.5 * p["x"] @ prec_g @ p["x"], {"x": torch.zeros(3).cuda()},
                      config=cfg, num_chains=4, draws=draws)
    assert _rel(card.samples["x"].cpu().numpy(), cpu.samples["x"].numpy()) <= 1e-4
    torch.testing.assert_close(card.accept_rate.cpu(), cpu.accept_rate)
