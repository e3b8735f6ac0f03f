"""Exact spectral diffusion-kernel GP (trainable β, σ_f over the eigenbasis).

Counterpart of ``graphgp_tpu/gp/spectral.py``: one ``eigh`` of the normalized
Laplacian up front, then every marginal-likelihood evaluation is
``K = Q diag(σ_f² e^{−βλ}) Qᵀ``, a differentiable elementwise exponential and
two matrix products: no matrix exponential, no second decomposition.

Spectral features ``Φ = Q diag(σ_f e^{−βλ/2})`` satisfy ``K = ΦΦᵀ`` exactly, so
this is the zero-variance limit of the GRF feature stack.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..devices import resolve_device
from ..graphs import normalized_laplacian
from ..linalg import cholesky_solve, safe_cholesky
from ..modulators import softplus
from . import params as P
from .exact import _LOG2PI, Posterior


@dataclasses.dataclass(frozen=True)
class Eigenbasis:
    evals: torch.Tensor  # (N,)
    evecs: torch.Tensor  # (N, N), columns are eigenvectors


def eigenbasis(adj, device="cuda") -> Eigenbasis:
    """Eigendecomposition of the normalized Laplacian (float32 ``eigh`` on
    ``device``)."""
    dense = adj.toarray() if sp.issparse(adj) else np.asarray(adj)
    dev = resolve_device(device)
    lap = normalized_laplacian(torch.from_numpy(np.asarray(dense, dtype=np.float32)).to(dev))
    evals, evecs = torch.linalg.eigh(lap)
    return Eigenbasis(evals=evals, evecs=evecs)


def init_params(
    noise: float = 0.1, beta: float = 1.0, sigma_f: float = 1.0, device="cpu"
) -> Dict[str, torch.Tensor]:
    return P.init_params("exact_diffusion", 2, noise=noise, beta=beta, sigma_f=sigma_f,
                         device=device)


def _spectral_phi(eig: Eigenbasis, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    beta = softplus(params["raw_beta"])
    sigma_f = softplus(params["raw_sigma_f"])
    return eig.evecs * (sigma_f * torch.exp(-0.5 * beta * eig.evals))[None, :]


@dataclasses.dataclass(frozen=True)
class SpectralDiffusionFeatures:
    """Features-protocol adapter for the EXACT diffusion kernel:
    ``Φ(β, σ_f) = Q diag(σ_f e^{−βλ/2})``, so ``K = ΦΦᵀ = σ_f² expm(−βL)``
    with β and σ_f trainable. Use with ``kind='exact_diffusion'``, whose
    "modulator" is the (β, σ_f) pair (``gp.params.modulator``) applied here on
    the eigenvalues: no Taylor truncation anywhere."""

    eig: Eigenbasis

    @property
    def num_nodes(self) -> int:
        return self.eig.evecs.shape[0]

    @property
    def num_target_nodes(self) -> int:
        return self.eig.evecs.shape[0]

    @property
    def max_walk_length(self) -> int:
        # length of the (β, σ_f) "modulator" vector of this kind
        return 2

    def _phi(self, f) -> torch.Tensor:
        f = torch.as_tensor(f, dtype=torch.float32, device=self.eig.evecs.device)
        beta, sigma_f = f[0], f[1]
        return self.eig.evecs * (sigma_f * torch.exp(-0.5 * beta * self.eig.evals))[None, :]

    def rows(self, f, idx):
        return self._phi(f)[idx]

    def matvec(self, f, v):
        return self._phi(f) @ v

    def rmatvec(self, f, v):
        return self._phi(f).T @ v

    def matvec_bm(self, f, v):
        return v @ self._phi(f).T

    def rmatvec_bm(self, f, v):
        return v @ self._phi(f)


def _train_system(eig, params, train_idx):
    """(Φ, Φ_train, lower Cholesky factor of K_tt + σ²I)."""
    phi = _spectral_phi(eig, params)
    phi_t = phi[train_idx]
    n = train_idx.shape[0]
    a = phi_t @ phi_t.T + P.noise_variance(params) * torch.eye(
        n, dtype=phi_t.dtype, device=phi_t.device
    )
    return phi, phi_t, safe_cholesky(a, jitter=1e-6)


def mll(
    eig: Eigenbasis, params: Dict[str, torch.Tensor], train_idx: torch.Tensor, y: torch.Tensor
) -> torch.Tensor:
    """Log marginal likelihood ``log N(y | 0, K_tt + σ²I)`` (natural units)."""
    _, _, chol = _train_system(eig, params, train_idx)
    alpha = cholesky_solve(chol, y)
    logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
    return -0.5 * (y @ alpha + logdet + y.shape[0] * _LOG2PI)


@torch.no_grad()
def predict(
    eig: Eigenbasis,
    params: Dict[str, torch.Tensor],
    train_idx: torch.Tensor,
    y: torch.Tensor,
    test_idx: torch.Tensor,
) -> Posterior:
    """Exact posterior mean and latent variance at test node indices."""
    phi, phi_tr, chol = _train_system(eig, params, train_idx)
    phi_te = phi[test_idx]
    k_st = phi_te @ phi_tr.T
    mean = k_st @ cholesky_solve(chol, y)
    v = torch.linalg.solve_triangular(chol, k_st.T, upper=False)
    var = torch.clamp((phi_te * phi_te).sum(dim=-1) - (v * v).sum(dim=0), min=1e-12)
    return Posterior(mean=mean, var=var)


@dataclasses.dataclass
class FitResult:
    params: Dict[str, torch.Tensor]
    losses: torch.Tensor


def fit(
    eig: Eigenbasis,
    train_idx: torch.Tensor,
    y: torch.Tensor,
    *,
    init: Optional[Dict[str, torch.Tensor]] = None,
    learning_rate: float = 0.05,
    num_steps: int = 200,
) -> FitResult:
    """``num_steps`` Adam steps on the negative marginal likelihood, a host
    loop where the JAX package scans. ``losses[i]`` is the loss at the
    parameters step i started from."""
    dev = y.device
    if init is None:
        init = init_params()
    p = {k: v.detach().clone().to(dev).requires_grad_(True) for k, v in init.items()}
    opt = torch.optim.Adam(list(p.values()), lr=learning_rate)
    losses = []
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=True)
        loss = -mll(eig, p, train_idx, y)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return FitResult(
        params={k: v.detach() for k, v in p.items()},
        losses=torch.stack(losses) if losses else torch.zeros(0, device=dev),
    )
