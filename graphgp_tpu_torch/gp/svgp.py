"""Sparse variational GP (SVGP) with inducing node indices.

Counterpart of ``graphgp_tpu/gp/svgp.py`` (the reference's GPflow SVGP for
Cora multiclass classification: MultiClass likelihood, inducing points = half
the train nodes, whitened, Adam lr 0.003 × 1000).

Whitened q(u) = N(m, L Lᵀ) per latent GP (one per class). Three likelihoods:
**robustmax** (analytic Gauss–Hermite expectations of GPflow's RobustMax
MultiClass likelihood, the protocol's default), softmax (Monte-Carlo,
reparameterized) and gaussian (closed form). Node covariances come from the
GRF feature rows Φ[idx] of any layout with ``rows`` (``DenseFeatures``,
``SpectralDiffusionFeatures``): no N×N matrix.

Draws are explicit where a test must feed both packages the same noise:
the softmax likelihood's ``eps`` and ``fit``'s ``init``; otherwise they come
from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..linalg import safe_cholesky
from . import params as P


def init_variational(
    kind: str,
    max_walk_length: int,
    num_inducing: int,
    num_latent: int,
    *,
    generator: Optional[torch.Generator] = None,
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """Kernel hyperparameters and whitened variational parameters: ``q_mu``
    (M, C) zeros, ``q_sqrt`` (C, M, M) identities."""
    params = P.init_params(kind, max_walk_length, generator=generator, device=device)
    params["q_mu"] = torch.zeros((num_inducing, num_latent), dtype=torch.float32, device=device)
    eye = torch.eye(num_inducing, dtype=torch.float32, device=device)
    params["q_sqrt"] = eye[None].repeat(num_latent, 1, 1)
    return params


class LatentPosterior(NamedTuple):
    mean: torch.Tensor  # (n, C)
    var: torch.Tensor  # (n, C)


def _latent_posterior(feats, params, inducing_idx, x_idx, kind: str) -> LatentPosterior:
    """q(f(x)) marginals under whitened q(u): mean = A m and
    var = diag(K_xx − A Aᵀ + A S Aᵀ), with A = K_xz L_zz^{-T}."""
    f = P.modulator(kind, params, feats.max_walk_length)
    phi_z = feats.rows(f, inducing_idx)  # (M, Nt)
    phi_x = feats.rows(f, x_idx)  # (n, Nt)
    l_zz = safe_cholesky(phi_z @ phi_z.T, jitter=1e-5)
    k_xz = phi_x @ phi_z.T
    a = torch.linalg.solve_triangular(l_zz, k_xz.T, upper=False)  # (M, n)
    mean = a.T @ params["q_mu"]  # (n, C)
    k_diag = torch.sum(phi_x * phi_x, dim=-1)
    var_prior = k_diag[:, None] - torch.sum(a * a, dim=0)[:, None]  # (n, 1)
    sa = torch.einsum("cmk,mn->ckn", params["q_sqrt"], a)  # (C, M, n)
    var_q = torch.sum(sa * sa, dim=1).T  # (n, C)
    return LatentPosterior(mean=mean, var=torch.clamp(var_prior + var_q, min=1e-10))


def _kl_whitened(params) -> torch.Tensor:
    """KL(q(u) || N(0, I)) of the whitened q, summed over the latents."""
    q_mu, q_sqrt = params["q_mu"], params["q_sqrt"]
    m, c = q_mu.shape[0], q_sqrt.shape[0]
    diag = torch.abs(torch.diagonal(q_sqrt, dim1=-2, dim2=-1)) + 1e-12
    logdet = 2.0 * torch.sum(torch.log(diag))
    return 0.5 * (torch.sum(q_mu**2) + torch.sum(q_sqrt**2) - c * m - logdet)


def softmax_expected_loglik(post: LatentPosterior, labels, eps: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo Σ_n E_q[log softmax(f_n)[y_n]] over the standard-normal
    draws ``eps`` (S, n, C)."""
    f = post.mean[None] + torch.sqrt(post.var)[None] * eps
    logp = torch.log_softmax(f, dim=-1)
    idx = labels.long()[None, :, None].expand(f.shape[0], -1, 1)
    return torch.sum(torch.mean(torch.gather(logp, -1, idx)[..., 0], dim=0))


def _gh_nodes(num_gh: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    gh_x, gh_w = np.polynomial.hermite.hermgauss(num_gh)
    return (torch.as_tensor(gh_x, dtype=torch.float32, device=device),
            torch.as_tensor(gh_w, dtype=torch.float32, device=device))


def _prob_is_largest(post: LatentPosterior, sel: torch.Tensor, num_gh: int) -> torch.Tensor:
    """P(f_sel(n) = max_c f_c(n)) under the factorized Gaussians q(f_n): 1-D
    Gauss–Hermite quadrature over the selected latent, the competitors by
    their normal CDFs (GPflow's ``RobustMax.prob_is_largest``). ``sel`` (n,)
    class indices; returns (n,)."""
    gh_x, gh_w = _gh_nodes(num_gh, post.mean.device)
    n, c = post.mean.shape
    sel = sel.long()
    n_idx = torch.arange(n, device=post.mean.device)
    mu_sel = post.mean[n_idx, sel]
    var_sel = post.var[n_idx, sel]
    grid = mu_sel[:, None] + gh_x[None, :] * torch.sqrt(torch.clamp(2.0 * var_sel, min=1e-10))[:, None]
    dist = (grid[:, None, :] - post.mean[:, :, None]) / torch.sqrt(
        torch.clamp(post.var, min=1e-10)
    )[:, :, None]
    cdfs = torch.special.ndtr(dist)  # (n, C, P)
    # squashed into (1e-4, 1 - 1e-4) to keep log-gradients finite, as GPflow
    cdfs = cdfs * (1.0 - 2e-4) + 1e-4
    oh_on = torch.nn.functional.one_hot(sel, c).to(cdfs.dtype)[:, :, None]
    cdfs = cdfs * (1.0 - oh_on) + oh_on
    return (torch.prod(cdfs, dim=1) @ gh_w) / math.sqrt(math.pi)


def robustmax_expected_loglik(
    post: LatentPosterior, labels, epsilon: float = 1e-3, num_gh: int = 20
) -> torch.Tensor:
    """Analytic Σ_n E_q[log p(y_n | f_n)] of the RobustMax likelihood:
    p(y=c|f) = 1−ε if argmax f = c, else ε/(C−1), so the expectation is
    P·log(1−ε) + (1−P)·log(ε/(C−1)) with P by quadrature."""
    p = _prob_is_largest(post, labels, num_gh)
    num_classes = post.mean.shape[1]
    ve = p * math.log(1.0 - epsilon) + (1.0 - p) * math.log(epsilon / (num_classes - 1))
    return torch.sum(ve)


def robustmax_class_probs(
    post: LatentPosterior, epsilon: float = 1e-3, num_gh: int = 20
) -> torch.Tensor:
    """Predictive class probabilities (n, C): (1−ε)·P_c + (1−P_c)·ε/(C−1)."""
    n, c = post.mean.shape
    p = torch.stack([
        _prob_is_largest(post, torch.full((n,), cls, dtype=torch.long, device=post.mean.device),
                         num_gh)
        for cls in range(c)
    ], dim=1)
    return (1.0 - epsilon) * p + (1.0 - p) * epsilon / (c - 1)


def gaussian_expected_loglik(post: LatentPosterior, y, noise_var) -> torch.Tensor:
    """Closed-form Σ_n E_q[log N(y_n | f_n, σ²)]."""
    lognorm = -0.5 * torch.log(2 * math.pi * noise_var)
    quad = -0.5 * ((y - post.mean[:, 0]) ** 2 + post.var[:, 0]) / noise_var
    return torch.sum(lognorm + quad)


def _mc_eps(eps, generator, num_samples, shape, device) -> torch.Tensor:
    if eps is not None:
        return eps
    return torch.randn((num_samples, *shape), generator=generator, device=device)


def elbo(
    feats,
    params,
    inducing_idx,
    train_idx,
    y,
    *,
    kind: str = "free",
    likelihood: str = "softmax",
    num_mc_samples: int = 8,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """ELBO = expected log-likelihood − KL. The softmax likelihood averages
    over ``eps`` (num_mc_samples, n, C), drawn from ``generator`` if absent."""
    post = _latent_posterior(feats, params, inducing_idx, train_idx, kind)
    if likelihood == "softmax":
        eps = _mc_eps(eps, generator, num_mc_samples, post.mean.shape, post.mean.device)
        ell = softmax_expected_loglik(post, y, eps)
    elif likelihood == "robustmax":
        ell = robustmax_expected_loglik(post, y)
    elif likelihood == "gaussian":
        ell = gaussian_expected_loglik(post, y, P.noise_variance(params))
    else:
        raise ValueError(f"unknown likelihood {likelihood!r}")
    return ell - _kl_whitened(params)


@torch.no_grad()
def predict_latent(feats, params, inducing_idx, test_idx, kind: str = "free") -> LatentPosterior:
    return _latent_posterior(feats, params, inducing_idx, test_idx, kind)


@torch.no_grad()
def predict_class_probs(
    feats,
    params,
    inducing_idx,
    test_idx,
    *,
    kind: str = "free",
    num_samples: int = 64,
    likelihood: str = "softmax",
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Predictive class probabilities (n_test, C): robustmax by the analytic
    quadrature (the reference's ``predict_y``); softmax as the posterior
    mean of the softmax over ``eps`` (num_samples, n_test, C)."""
    post = _latent_posterior(feats, params, inducing_idx, test_idx, kind)
    if likelihood == "robustmax":
        return robustmax_class_probs(post)
    eps = _mc_eps(eps, generator, num_samples, post.mean.shape, post.mean.device)
    f = post.mean[None] + torch.sqrt(post.var)[None] * eps
    return torch.mean(torch.softmax(f, dim=-1), dim=0)


@torch.no_grad()
def predict_class(
    feats, params, inducing_idx, test_idx, *, kind: str = "free", likelihood: str = "softmax"
) -> torch.Tensor:
    """Hard class predictions, deterministic like the reference's argmax of
    GPflow ``predict_y``: robustmax, the argmax of the analytic class
    probabilities; softmax, the argmax of the latent posterior means (a
    Monte-Carlo average buries the class order of a lightly trained q(u) in
    sampling noise)."""
    post = _latent_posterior(feats, params, inducing_idx, test_idx, kind)
    if likelihood == "robustmax":
        return torch.argmax(robustmax_class_probs(post), dim=-1)
    return torch.argmax(post.mean, dim=-1)


@dataclasses.dataclass
class FitResult:
    params: Dict[str, torch.Tensor]
    losses: torch.Tensor


def fit(
    feats,
    inducing_idx,
    train_idx,
    y,
    *,
    num_latent: int,
    kind: str = "free",
    likelihood: str = "softmax",
    generator: Optional[torch.Generator] = None,
    init: Optional[Dict[str, torch.Tensor]] = None,
    learning_rate: float = 3e-3,
    num_steps: int = 1000,
    num_mc_samples: int = 8,
) -> FitResult:
    """Adam on the negative ELBO, a host loop of ``torch.optim.Adam`` steps
    (the reference Cora protocol: lr 0.003 × 1000, whitened). The free
    modulator's initial draw and the softmax likelihood's draws come from
    ``generator`` (seeded with 42 when absent); ``init`` gives the starting
    parameters explicitly."""
    dev = y.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(42)
    if init is None:
        init = init_variational(kind, feats.max_walk_length, int(inducing_idx.shape[0]),
                                num_latent, generator=generator, device=dev)
    p = {k: v.detach().clone().to(dev).requires_grad_(True) for k, v in init.items()}
    opt = torch.optim.Adam(list(p.values()), lr=learning_rate)
    losses = []
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=True)
        loss = -elbo(feats, p, inducing_idx, train_idx, y, kind=kind, likelihood=likelihood,
                     num_mc_samples=num_mc_samples, generator=generator)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return FitResult(
        params={k: v.detach() for k, v in p.items()},
        losses=torch.stack(losses) if losses else torch.zeros(0, device=dev),
    )
