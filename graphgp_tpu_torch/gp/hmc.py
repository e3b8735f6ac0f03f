"""HMC over GRF-GP hyperparameter posteriors (modulator vector / β, σ_f, noise).

Counterpart of ``graphgp_tpu/gp/hmc.py``: fixed-path-length HMC with a
diagonal mass, Stan-style windowed mass adaptation and per-chain
dual-averaging step sizes during warmup (Hoffman & Gelman 2014, Algorithm
5), Laplace whitening around a refined mode, and split-chain R̂.

The chains are a batch axis. ``log_prob_fn`` takes one chain's parameter
dict; ``torch.func.vmap`` turns it into one evaluation over all chains (on
the dense GP: Φ_train (C, n, Nt), the Gram (C, n, n), one batched
Cholesky), and autograd of the chains' summed log densities gives every
chain's gradient at once. The iterations run in a host loop that never
waits for the device: the adaptation's schedule depends only on the
iteration number, and every per-chain decision is a ``torch.where``. On
CUDA each trajectory (every leapfrog step's evaluation and backward) is one
CUDA graph, captured once a run and replayed.

Draws. The JAX package's ``jax.random`` streams cannot be reproduced here,
so :func:`sample` takes a CPU ``torch.Generator`` and, optionally, the draws
themselves (:class:`HMCDraws`): a test can hand both packages the same
numbers, and the card and the CPU the same run.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

LogProbFn = Callable[[Dict[str, torch.Tensor]], torch.Tensor]
Spec = Tuple[Tuple[str, ...], Tuple[torch.Size, ...], Tuple[int, ...]]

# Batched log-density-and-gradient evaluations made by the samplers (each one
# covers every chain); read by the drivers for evaluations per second.
gradient_evaluations = 0


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    num_warmup: int = 200
    num_samples: int = 300
    num_leapfrog: int = 16
    initial_step_size: float = 0.05
    target_accept: float = 0.8
    # dual averaging constants (Hoffman & Gelman 2014)
    gamma: float = 0.05
    t0: float = 10.0
    kappa: float = 0.75
    # diagonal mass adaptation, Stan-style windows: per-dimension posterior
    # variance (Welford) frozen into the mass at 1/4, 1/2 and 3/4 of warmup,
    # each freeze restarting dual averaging around the current step size
    adapt_mass: bool = True
    # step-size jitter: iteration t's leapfrog step is ε·(1 + step_jitter·(2u
    # − 1)), u uniform (Neal 2011, §5.4.2.3). A fixed path length L·ε that
    # lands near a whole period of a near-Gaussian direction brings every
    # trajectory back to its start there, and that chain stops moving in it
    # while accepting nearly every proposal. 0 is the JAX package's sampler.
    step_jitter: float = 0.0


class HMCResult(NamedTuple):
    samples: Dict[str, torch.Tensor]  # leading axes (num_chains, num_samples)
    accept_rate: torch.Tensor  # (num_chains,), after warmup
    step_size: torch.Tensor  # (num_chains,) adapted step sizes
    log_probs: torch.Tensor  # (num_chains, num_samples)
    # (num_chains, warmup + samples): step size and acceptance probability of
    # every iteration, the adaptation trace
    eps_trace: Optional[torch.Tensor] = None
    accept_trace: Optional[torch.Tensor] = None


class HMCDraws(NamedTuple):
    """Every random number of a run, standard normals unless stated.

    init: (C, dim); a chain starts at ``q0 + 0.01 · init``.
    momentum: (C, T, dim); iteration t's momentum is ``momentum[:, t] /
        sqrt(inv_mass)``.
    uniform: (C, T) in [0, 1); iteration t accepts where ``log uniform[:, t]
        < log_accept``.
    step_scale: (C, T) positive, or None (the JAX package's sampler);
        iteration t's leapfrog step is its step size times
        ``step_scale[:, t]`` (``HMCConfig.step_jitter``).
    """

    init: torch.Tensor
    momentum: torch.Tensor
    uniform: torch.Tensor
    step_scale: Optional[torch.Tensor] = None


def draw(
    num_chains: int, num_iterations: int, dim: int, generator: Optional[torch.Generator] = None,
    step_jitter: float = 0.0,
) -> HMCDraws:
    """A run's draws, made on the CPU from ``generator`` (so a run on the card
    and one on the CPU from the same seed see the same numbers). The step
    scales are drawn last, and only for ``step_jitter > 0``: the other draws
    do not depend on it."""
    init = torch.randn((num_chains, dim), generator=generator)
    momentum = torch.randn((num_chains, num_iterations, dim), generator=generator)
    uniform = torch.rand((num_chains, num_iterations), generator=generator)
    scale = None
    if step_jitter > 0:
        u = torch.rand((num_chains, num_iterations), generator=generator)
        scale = 1.0 + step_jitter * (2.0 * u - 1.0)
    return HMCDraws(init, momentum, uniform, scale)


def _flatten(params: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Spec]:
    """One float32 vector of a parameter dict, its entries in sorted key order
    (the order in which the JAX package flattens a dict), and its layout."""
    names = tuple(sorted(params))
    leaves = [torch.as_tensor(params[k], dtype=torch.float32) for k in names]
    shapes = tuple(leaf.shape for leaf in leaves)
    sizes = tuple(leaf.numel() for leaf in leaves)
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves]) if leaves else torch.zeros(0)
    return flat, (names, shapes, sizes)


def _unflatten(flat: torch.Tensor, spec: Spec) -> Dict[str, torch.Tensor]:
    """The parameter dict of ``flat`` (..., dim), leading axes kept."""
    names, shapes, sizes = spec
    lead = flat.shape[:-1]
    out, pos = {}, 0
    for name, shape, size in zip(names, shapes, sizes):
        out[name] = flat[..., pos:pos + size].reshape(tuple(lead) + tuple(shape))
        pos += size
    return out


def _batched_value_and_grad(logp_flat: Callable[[torch.Tensor], torch.Tensor]):
    """``vg(q) -> (logp, ∇logp)`` for q (C, dim): one vmapped evaluation over
    the chains and one backward pass of their sum (the chains are
    independent, so that is every chain's gradient)."""
    batched = torch.func.vmap(logp_flat)

    def vg(q: torch.Tensor):
        with torch.enable_grad():
            x = q.detach().requires_grad_(True)
            val = batched(x)
            (grad,) = torch.autograd.grad(val.sum(), x)
        return val.detach(), grad

    return vg


def _trajectory(value_and_grad, q, p, val, grad, step_size, num_steps: int, inv_mass):
    """Leapfrog from (q, p) whose log density and gradient at q are (val,
    grad); returns the end point, its momentum, log density and gradient.
    Every step uses the gradient at both its ends; the one at a step's end is
    the next step's start, so it is evaluated once (num_steps evaluations)."""
    for _ in range(num_steps):
        p = p + 0.5 * step_size * grad
        q = q + step_size * inv_mass * p
        val, grad = value_and_grad(q)
        p = p + 0.5 * step_size * grad
    return q, p, val, grad


def _graphed_trajectory(value_and_grad, num_steps: int, example):
    """``_trajectory`` over ``num_steps`` leapfrog steps as one CUDA graph,
    replayed for every trajectory of a run: a step's batched evaluation is
    a few hundred small launches (vmap, autograd, a batched Cholesky),
    which the host issues far slower than the card runs them. ``example``
    holds tensors shaped as (q, p, val, grad, step_size, inv_mass); the
    returned function takes such tensors and returns fresh ones."""
    static_in = [t.detach().clone() for t in example]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up launches outside the capture
        _trajectory(value_and_grad, *static_in[:4], static_in[4], num_steps, static_in[5])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = _trajectory(value_and_grad, *static_in[:4], static_in[4], num_steps,
                                 static_in[5])

    def run(q, p, val, grad, step_size, inv_mass):
        for dst, src in zip(static_in, (q, p, val, grad, step_size, inv_mass)):
            dst.copy_(src)
        graph.replay()
        return tuple(t.clone() for t in static_out)

    return run


def _leapfrog(grad_fn, q, p, step_size, num_steps: int, inv_mass):
    """Leapfrog with diagonal mass: H = −logp(q) + ½ pᵀ M⁻¹ p."""
    q, p, _, _ = _trajectory(
        lambda x: (None, grad_fn(x)), q, p, None, grad_fn(q), step_size, num_steps, inv_mass
    )
    return q, p


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _run_chains(log_prob_fn: LogProbFn, flat0: torch.Tensor, spec: Spec, draws: HMCDraws,
                config: HMCConfig):
    """All chains of ``draws`` in lockstep, as the JAX package's ``one_chain``
    under ``vmap``: (qs (C, S, dim), log probs (C, S), accept rates, step
    sizes, eps trace, accept trace)."""
    dev = flat0.device
    c = draws.init.shape[0]
    momentum, uniform = draws.momentum.to(dev), draws.uniform.to(dev)
    scale = None if draws.step_scale is None else draws.step_scale.to(dev)
    vg = _batched_value_and_grad(lambda q: log_prob_fn(_unflatten(q, spec)))

    global gradient_evaluations
    q = flat0[None, :] + 0.01 * draws.init.to(dev)
    lp, grad = vg(q)
    gradient_evaluations += 1
    wu = config.num_warmup
    # Stan-style windowed warmup: the mass is re-estimated and dual averaging
    # restarted at the end of each window
    switches = {wu // 4, wu // 2, (3 * wu) // 4} if config.adapt_mass and wu >= 20 else set()
    log_eps = torch.log(_f32(config.initial_step_size, dev)).expand(c).clone()
    log_eps_bar = log_eps.clone()
    mu = torch.log(_f32(10.0 * config.initial_step_size, dev)).expand(c).clone()
    h_bar = torch.zeros(c, device=dev)
    accepts = torch.zeros(c, device=dev)
    inv_mass = torch.ones_like(q)
    w_mean, w_m2, w_cnt = torch.zeros_like(q), torch.zeros_like(q), 0.0
    wt = 0.0  # iterations since the last window boundary
    qs, lps, eps_tr, a_tr = [], [], [], []
    if dev.type == "cuda":
        trajectory = _graphed_trajectory(
            vg, config.num_leapfrog, (q, q, lp, grad, log_eps[:, None], inv_mass))
    else:
        trajectory = lambda *a: _trajectory(vg, *a[:5], config.num_leapfrog, a[5])
    for it in range(wu + config.num_samples):
        warm = it < wu
        eps = torch.exp(log_eps)
        step = eps if scale is None else eps * scale[:, it]
        p0 = momentum[:, it] / torch.sqrt(inv_mass)
        q_new, p_new, lp_new, grad_new = trajectory(q, p0, lp, grad, step[:, None], inv_mass)
        gradient_evaluations += config.num_leapfrog
        h0 = lp - 0.5 * (inv_mass * p0 ** 2).sum(-1)
        h1 = lp_new - 0.5 * (inv_mass * p_new ** 2).sum(-1)
        log_accept = torch.minimum(h1 - h0, torch.zeros_like(h0))
        # a divergent trajectory (non-finite energy) is a rejection
        log_accept = torch.where(torch.isfinite(log_accept), log_accept, -math.inf)
        accept = torch.log(uniform[:, it]) < log_accept
        q = torch.where(accept[:, None], q_new, q)
        lp = torch.where(accept, lp_new, lp)
        grad = torch.where(accept[:, None], grad_new, grad)

        if switches:
            if warm:  # Welford accumulation since the last window boundary
                w_cnt += 1.0
                delta = q - w_mean
                w_mean = w_mean + delta / w_cnt
                w_m2 = w_m2 + delta * (q - w_mean)
            if warm and it + 1 in switches:
                # regularize toward unit (Stan's shrinkage) and floor
                est_var = w_m2 / max(w_cnt - 1.0, 1.0)
                inv_mass = torch.clamp(0.9 * est_var + 0.1, min=1e-4)
                # restart Welford and dual averaging around the current step
                # size: the new mass changes what ε means
                w_mean, w_m2, w_cnt = torch.zeros_like(q), torch.zeros_like(q), 0.0
                h_bar = torch.zeros_like(h_bar)
                mu = math.log(10.0) + log_eps
                wt = 0.0

        # dual averaging, warmup only: t counts within the window, so each
        # mass freeze re-adapts ε, while ε̄ is weighted by the global iteration
        a_prob = torch.exp(log_accept)
        if warm:
            t = wt + 1.0
            eta = 1.0 / (t + config.t0)
            h_bar = (1 - eta) * h_bar + eta * (config.target_accept - a_prob)
            log_eps = mu - math.sqrt(t) / config.gamma * h_bar
            x_eta = (it + 1.0) ** (-config.kappa)
            log_eps_bar = x_eta * log_eps + (1 - x_eta) * log_eps_bar
        else:
            log_eps = log_eps_bar
            accepts = accepts + accept.to(torch.float32)
        wt += 1.0
        if not warm:
            qs.append(q)
            lps.append(lp)
        eps_tr.append(torch.exp(log_eps))
        a_tr.append(a_prob)
    stack = lambda xs, like: torch.stack(xs, 1) if xs else like
    return (
        stack(qs, q.new_zeros((c, 0, q.shape[1]))), stack(lps, lp.new_zeros((c, 0))),
        accepts / config.num_samples, torch.exp(log_eps_bar),
        stack(eps_tr, lp.new_zeros((c, 0))), stack(a_tr, lp.new_zeros((c, 0))),
    )


def _chain_draws(draws: Optional[HMCDraws], num_chains: int, padded: int, total: int, dim: int,
                 generator: Optional[torch.Generator], step_jitter: float) -> HMCDraws:
    """Draws for ``padded`` chains: made from ``generator``, or the given
    ones (for ``num_chains``) with the last chain's repeated into the padding
    (padded chains are computed and dropped)."""
    if draws is None:
        return draw(padded, total, dim, generator, step_jitter)
    if step_jitter > 0 and draws.step_scale is None:
        raise ValueError(f"step_jitter {step_jitter} needs draws with step_scale")
    want = ((num_chains, dim), (num_chains, total, dim), (num_chains, total), (num_chains, total))
    got = tuple(tuple(d.shape) for d in draws if d is not None)
    if got != want[:len(got)]:
        raise ValueError(f"draws have shapes {got}; this run needs {want[:len(got)]}")
    extra = padded - num_chains
    return HMCDraws(*(None if d is None else torch.cat([d, d[-1:].expand(extra, *d.shape[1:])])
                      for d in draws))


def sample(
    log_prob_fn: LogProbFn,
    init_params: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    config: HMCConfig = HMCConfig(),
    num_chains: int = 4,
    mesh=None,
    *,
    draws: Optional[HMCDraws] = None,
) -> HMCResult:
    """Run ``num_chains`` HMC chains with dual-averaging warmup.

    ``log_prob_fn(params) -> scalar`` is one chain's unnormalized log
    posterior (e.g. exact.mll plus prior terms); it must be vmappable and,
    on CUDA, free of host syncs (its trajectories are a CUDA graph). Chains
    start from ``init_params`` (on the device to run on) jittered by
    0.01 · ``draws.init``.

    With ``mesh`` (``shard.make_mesh``), the chains are split over its ranks:
    ``num_chains`` is padded up to a multiple of the world size, each rank
    runs its block (``shard.sharded_hmc_chains``), and the results are
    gathered to every rank with the padding dropped. Chains see the same
    draws with and without a mesh.
    """
    flat0, spec = _flatten(init_params)
    dim = flat0.numel()
    total = config.num_warmup + config.num_samples
    padded = num_chains
    if mesh is not None:
        from ..shard import sharded_hmc_chains

        mine = sharded_hmc_chains(mesh, num_chains)
        padded = (mine.stop - mine.start) * mesh.size
    all_draws = _chain_draws(draws, num_chains, padded, total, dim, generator,
                             config.step_jitter)
    if mesh is None:
        out = _run_chains(log_prob_fn, flat0, spec, all_draws, config)
    else:
        from ..shard import all_gather_rows

        local = _run_chains(log_prob_fn, flat0.to(mesh.device), spec,
                            HMCDraws(*(None if d is None else d[mine] for d in all_draws)),
                            config)
        out = tuple(all_gather_rows(t, mesh)[:num_chains] for t in local)
    qs, lps, acc, eps, eps_tr, a_tr = out
    return HMCResult(samples=_unflatten(qs, spec), accept_rate=acc, step_size=eps,
                     log_probs=lps, eps_trace=eps_tr, accept_trace=a_tr)


def refine_mode(
    log_prob_fn: LogProbFn,
    init_params: Dict[str, torch.Tensor],
    num_steps: int = 100,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """L-BFGS ascent of ``log_prob_fn`` from ``init_params`` → (mode, −logp
    trace, each entry the value a step started from). Polish the mode before
    :func:`sample_laplace`: an Adam ML-II point can sit off the posterior mode
    along near-flat directions, and the Hessian there mis-scales the
    whitening. ``torch.optim.LBFGS`` with a strong-Wolfe line search, as
    ``exact.fit``; the JAX package's optax L-BFGS searches its lines
    otherwise, so the two agree on the mode, not on the iterates."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in init_params.items()}
    # one iteration a step(); max_eval leaves the line search its evaluations
    opt = torch.optim.LBFGS(list(p.values()), lr=1.0, max_iter=1, max_eval=26,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad(set_to_none=True)
        loss = -log_prob_fn(p)
        loss.backward()
        return loss

    losses = [opt.step(closure).detach() for _ in range(num_steps)]
    dev = next(iter(p.values())).device
    return ({k: v.detach() for k, v in p.items()},
            torch.stack(losses) if losses else torch.zeros(0, device=dev))


def laplace_whitening(
    log_prob_fn: LogProbFn, mode_params: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, Spec]:
    """(q*, Σ^{1/2}, layout) at a posterior mode: Σ = (−∇²logp(q*))⁻¹ with the
    precision's eigenvalues floored *relative* to the largest, at
    ``max(1e-4 · λmax, 1e-10)``: a near-flat direction cannot blow the
    whitened scale up beyond 100× the stiffest one, which the mass
    adaptation then finishes off. ``Σ^{1/2} = V · diag(λ^{-1/2})``; its
    columns' signs are whatever ``eigh`` gives, so compare Σ^{1/2}Σ^{1/2}ᵀ
    across libraries, not Σ^{1/2}."""
    flat0, spec = _flatten(mode_params)
    h = torch.func.hessian(lambda q: log_prob_fn(_unflatten(q, spec)))(flat0)
    prec = -0.5 * (h + h.T)
    evals_raw, evecs = torch.linalg.eigh(prec)
    evals = torch.maximum(evals_raw, torch.clamp(1e-4 * evals_raw.max(), min=1e-10))
    if os.environ.get("GRAPHGP_HMC_DEBUG"):
        print("sample_laplace: precision eigvals (raw)", evals_raw.cpu().numpy(),
              "clipped", evals.cpu().numpy(), flush=True)
    return flat0, evecs * (1.0 / torch.sqrt(evals))[None, :], spec


def sample_laplace(
    log_prob_fn: LogProbFn,
    mode_params: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    config: HMCConfig = HMCConfig(),
    num_chains: int = 4,
    mesh=None,
    *,
    draws: Optional[HMCDraws] = None,
) -> HMCResult:
    """HMC in the Laplace-whitened space around a posterior mode.

    GP hyperparameter posteriors are severely anisotropic in the raw
    (softplus-inverse) coordinates, so one step size cannot serve them all.
    With q = q* + Σ^{1/2} z (:func:`laplace_whitening`) the z-posterior is
    ≈ N(0, I) near the mode; HMC runs on z and the samples are mapped back
    to the parameter dict. ``draws`` are in z's coordinates."""
    flat0, sqrt_cov, spec = laplace_whitening(log_prob_fn, mode_params)

    def log_prob_z(zp):
        return log_prob_fn(_unflatten(flat0 + sqrt_cov @ zp["z"], spec))

    res = sample(log_prob_z, {"z": torch.zeros_like(flat0)}, generator, config, num_chains,
                 mesh, draws=draws)
    qs = flat0.to(sqrt_cov.device) + torch.einsum("ij,csj->csi", sqrt_cov, res.samples["z"])
    return res._replace(samples=_unflatten(qs, spec))


def split_rhat(x: torch.Tensor) -> torch.Tensor:
    """Split-chain potential-scale-reduction R̂ (Gelman et al., BDA3).

    x: (num_chains, num_draws, *param_shape) → R̂ of shape param_shape. Each
    chain is split in half, so drift within a chain shows as well as
    disagreement between chains."""
    half = x.shape[1] // 2
    chains = torch.cat([x[:, :half], x[:, half:2 * half]], dim=0)
    w = chains.var(dim=1, correction=1).mean(dim=0)
    b = half * chains.mean(dim=1).var(dim=0, correction=1)
    var_plus = (half - 1) / half * w + b / half
    return torch.sqrt(var_plus / torch.clamp(w, min=1e-30))


def split_rhat_tree(samples: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-parameter split-chain R̂ of a samples dict with leading (chains,
    draws) axes, keys in sorted order."""
    return {k: split_rhat(samples[k]) for k in sorted(samples)}


def make_gp_log_posterior(
    mll_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    prior_std: float = 2.0,
    anchors: Optional[Dict[str, Tuple[float, float]]] = None,
) -> LogProbFn:
    """Posterior = mll + an iid Gaussian prior over every (unconstrained)
    parameter.

    ``anchors``: {param_name: (center, std)} extra Gaussian factors on raw
    parameters. The GP noise direction has a likelihood plateau as raw_noise
    → −∞ (softplus saturates): chains that wander onto it freeze and the
    adapted step size collapses for the whole run. A weak anchor at the ML-II
    noise removes the plateau without informing the bulk."""
    anchors = anchors or {}

    def log_prob(params):
        prior = 0
        for name in sorted(params):
            prior = prior + -0.5 * ((params[name] / prior_std) ** 2).sum()
        for name, (center, std) in anchors.items():
            prior = prior - 0.5 * (((params[name] - center) / std) ** 2).sum()
        return mll_fn(params) + prior

    return log_prob
