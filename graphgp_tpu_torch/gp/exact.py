"""Exact GP regression on graph nodes (Cholesky, small and medium N).

Counterpart of ``graphgp_tpu/gp/exact.py``: dense step matrices are sampled
once, the marginal likelihood is a differentiable contraction plus a
Cholesky factorization, and the hyperparameters are trained by
``torch.optim.Adam`` or ``torch.optim.LBFGS``. Inputs are node indices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..features import DenseFeatures
from ..linalg import cholesky_solve, safe_cholesky
from . import params as P

_LOG2PI = 1.8378770664093453


def _train_system(feats: DenseFeatures, params, train_idx, kind):
    """(Φ_train, lower Cholesky factor of K_tt + σ²I)."""
    f = P.modulator(kind, params, feats.max_walk_length)
    phi_t = feats.rows(f, train_idx)  # (n, Nt)
    n = train_idx.shape[0]
    a = phi_t @ phi_t.T + P.noise_variance(params) * torch.eye(
        n, dtype=phi_t.dtype, device=phi_t.device
    )
    return f, phi_t, safe_cholesky(a, jitter=1e-6)


def mll(
    feats: DenseFeatures,
    params: Dict[str, torch.Tensor],
    train_idx: torch.Tensor,
    y: torch.Tensor,
    kind: str = "free",
) -> torch.Tensor:
    """Log marginal likelihood ``log N(y | 0, K_tt + σ²I)`` (natural units)."""
    _, _, chol = _train_system(feats, params, train_idx, kind)
    alpha = cholesky_solve(chol, y)
    logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
    return -0.5 * (y @ alpha + logdet + y.shape[0] * _LOG2PI)


class Posterior(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor  # latent variance (add the noise for the predictive y-variance)


@torch.no_grad()
def predict(
    feats: DenseFeatures,
    params: Dict[str, torch.Tensor],
    train_idx: torch.Tensor,
    y: torch.Tensor,
    test_idx: torch.Tensor,
    kind: str = "free",
) -> Posterior:
    """Exact posterior mean and variance at test node indices."""
    f, phi_tr, chol = _train_system(feats, params, train_idx, kind)
    phi_te = feats.rows(f, test_idx)
    k_st = phi_te @ phi_tr.T
    mean = k_st @ cholesky_solve(chol, y)
    v = torch.linalg.solve_triangular(chol, k_st.T, upper=False)
    diag_test = (phi_te * phi_te).sum(dim=-1)
    var = torch.clamp(diag_test - (v * v).sum(dim=0), min=1e-12)
    return Posterior(mean=mean, var=var)


@dataclasses.dataclass
class FitResult:
    params: Dict[str, torch.Tensor]
    losses: torch.Tensor


def fit(
    feats: DenseFeatures,
    train_idx: torch.Tensor,
    y: torch.Tensor,
    *,
    kind: str = "free",
    generator: Optional[torch.Generator] = None,
    init: Optional[Dict[str, torch.Tensor]] = None,
    learning_rate: float = 0.05,
    num_steps: int = 300,
    optimizer: str = "adam",
    noise_prior_lognormal: Optional[Tuple[float, float]] = None,
) -> FitResult:
    """Maximize the marginal likelihood over kernel and noise hyperparameters.

    ``optimizer='adam'`` takes ``num_steps`` Adam steps at ``learning_rate``.
    ``optimizer='lbfgs'`` takes ``num_steps`` L-BFGS iterations, each with a
    strong-Wolfe line search (``learning_rate`` is not used, as in the JAX
    package); the JAX package's optax L-BFGS uses another line search, so the
    two agree on a decreasing loss, not on the iterates. ``losses[i]`` is the
    loss at the parameters step i started from.

    ``noise_prior_lognormal=(loc, scale)`` adds a LogNormal log-density on the
    noise variance to the objective (MAP).
    """
    if optimizer not in ("adam", "lbfgs"):
        raise ValueError(f"unknown optimizer {optimizer!r} (want 'adam'|'lbfgs')")
    dev = y.device
    if init is None:
        init = P.init_params(kind, feats.max_walk_length, generator=generator, device=dev)
    p = {k: v.detach().clone().to(dev).requires_grad_(True) for k, v in init.items()}

    def loss_fn() -> torch.Tensor:
        loss = -mll(feats, p, train_idx, y, kind=kind)
        if noise_prior_lognormal is not None:
            loc, scale = noise_prior_lognormal
            nv = P.noise_variance(p)
            z = (torch.log(nv) - loc) / scale  # LogNormal log-pdf up to a constant
            loss = loss - (-0.5 * z * z - torch.log(nv))
        return loss

    if optimizer == "lbfgs":
        # one L-BFGS iteration per step(); max_eval leaves the line search its
        # 25 evaluations (the default, max_iter·5/4, would leave it none)
        opt = torch.optim.LBFGS(list(p.values()), lr=1.0, max_iter=1, max_eval=26,
                                line_search_fn="strong_wolfe")
    else:
        opt = torch.optim.Adam(list(p.values()), lr=learning_rate)
    losses = []

    def closure():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        return loss

    for _ in range(num_steps):
        # step() returns the closure's first evaluation: the loss before the update
        losses.append(opt.step(closure).detach())
    return FitResult(
        params={k: v.detach() for k, v in p.items()},
        losses=torch.stack(losses) if losses else torch.zeros(0, device=dev),
    )


def nlpd(post: Posterior, params: Dict[str, torch.Tensor], y_test: torch.Tensor) -> torch.Tensor:
    """Observation-space negative log predictive density."""
    var = post.var + P.noise_variance(params)
    return (0.5 * (_LOG2PI + torch.log(var) + (y_test - post.mean) ** 2 / var)).mean()


def rmse(post: Posterior, y_test: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(((y_test - post.mean) ** 2).mean())
