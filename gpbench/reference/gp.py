"""Plain reference of the GP quantities a GRF-Thompson step computes, on
dense matrices over the observation slots.

The observation buffer has ``cap`` slots, ``mask`` marking the live ones.
Its operator is ``Ã = M K M + σ² M + (I - M)`` with ``K = Φ_t Φ_tᵀ`` over the
slots' rows of Φ (``M = diag(mask)``): padded slots are independent unit
variables, which add 0 to the quadratic and log 1 = 0 to the log-determinant.
The log-determinant is the stochastic Lanczos quadrature estimate on given
probe rows (Ubaru, Chen and Saad 2017), with full reorthogonalization.
Imports nothing of the program.
"""
from __future__ import annotations

import torch


def masked_operator(phi_slots: torch.Tensor, noise_var: float, mask: torch.Tensor) -> torch.Tensor:
    """``Ã`` (cap × cap) from Φ's rows at the slots (cap × C), in their dtype."""
    m = mask.to(phi_slots.dtype)
    k = phi_slots @ phi_slots.T
    a = m[:, None] * k * m[None, :]
    return a + torch.diag(noise_var * m + (1 - m))


def slq_logdet(a: torch.Tensor, probes: torch.Tensor, iters: int) -> tuple:
    """(estimate, scale): the SLQ estimate of ``logdet a`` from probe rows
    (P, n), the mean over probes of ``‖z_p‖² Σ_k τ_k² log θ_k`` over the
    Ritz pairs of ``iters`` Lanczos steps, and the same mean of
    ``‖z_p‖² Σ_k τ_k² |log θ_k|``, the size its rounding error scales with.
    (The estimate's Monte-Carlo error is no scale: where the observations'
    rows of Φ do not overlap, Ã is diagonal and every Rademacher probe gives
    the same value.) The tridiagonal is diagonalized in float64."""
    dt = a.dtype
    z = probes.to(dt)
    bsz, n = z.shape
    q = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=1e-30)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(bsz, dtype=dt, device=a.device)
    basis = torch.zeros((iters, bsz, n), dtype=dt, device=a.device)
    alphas, betas = [], []
    for k in range(iters):
        w = q @ a
        alpha = (q * w).sum(-1)
        w = w - alpha[:, None] * q - beta_prev[:, None] * q_prev
        proj = torch.einsum("mbn,bn->mb", basis, w)
        w = w - torch.einsum("mbn,mb->bn", basis, proj)
        beta = torch.linalg.vector_norm(w, dim=-1)
        basis[k] = q
        q_prev, q = q, w / torch.clamp(beta[:, None], min=1e-30)
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    al = torch.stack(alphas).T.to(torch.float64)
    be = torch.stack(betas)[:-1].T.to(torch.float64)
    t = torch.diag_embed(al)
    if iters > 1:
        off = torch.diag_embed(be, offset=1)
        t = t + off + off.transpose(-1, -2)
    evals, evecs = torch.linalg.eigh(t)
    tau = evecs[:, 0, :] ** 2
    logs = torch.log(torch.clamp(evals, min=1e-10))
    norms = (z.to(torch.float64) ** 2).sum(-1)
    est = (norms * (tau * logs).sum(-1)).mean()
    scale = (norms * (tau * logs.abs()).sum(-1)).mean()
    return float(est), float(scale)


def relative_residual(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    """``‖a x − b‖ / ‖b‖`` in float64."""
    a64, x64, b64 = a.to(torch.float64), x.to(torch.float64), b.to(torch.float64)
    return float(torch.linalg.vector_norm(a64 @ x64 - b64) /
                 torch.clamp(torch.linalg.vector_norm(b64), min=1e-300))


def cg(a: torch.Tensor, b: torch.Tensor, tol: float, max_iters: int) -> tuple:
    """Conjugate gradients on ``a x = b`` (b one vector), every operation in
    ``a``'s dtype, stopped where the recurrence's ‖r‖/‖b‖ is at or below
    ``tol`` or after ``max_iters`` iterations: the rule the configuration
    states for the solves. Returns ``x`` and the recurrence's final ‖r‖/‖b‖."""
    b = b.to(a.dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = r @ r
    b_norm = torch.linalg.vector_norm(b.to(torch.float64))
    for _ in range(max_iters):
        if float(torch.sqrt(rr.to(torch.float64))) <= tol * float(b_norm):
            break
        ap = a @ p
        alpha = rr / (p @ ap)
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = r @ r
        p = r + (rr_new / rr) * p
        rr = rr_new
    return x, float(torch.sqrt(rr.to(torch.float64))) / max(float(b_norm), 1e-300)


def noise_variance(raw: torch.Tensor) -> torch.Tensor:
    """softplus(raw) + 1e-6, the configuration's floored noise variance."""
    return torch.logaddexp(raw, torch.zeros_like(raw)) + 1e-6


def first_gradient(phi_steps: torch.Tensor, params: dict, y: torch.Tensor,
                   probes: torch.Tensor) -> dict:
    """Gradient of the negative log marginal likelihood's estimate at one
    Adam step, over the live observations: ``½ (yᵀ A⁻¹ y + logdet A)`` with
    ``A = K + σ² I``, ``K = Φ Φᵀ``, ``Φ = Σ_l f_l Φ_l``, the quadratic's part
    exact and the log-determinant's the Hutchinson estimate on the given
    probes, ``(1/P) Σ_p z_pᵀ A⁻¹ ∂A z_p``, with exact solves. This is the
    gradient that CG solves and adjoint solves estimate.

    ``phi_steps`` (L, n, C) holds the steps' rows at the live slots, summed
    in the dtype the caller chose (bfloat16 for the control); ``params`` the
    modulator ``f`` (L,) and ``raw_noise``; ``probes`` (P, n). The algebra is
    float64 autograd."""
    dev = phi_steps.device
    f = params["modulator"].to(dev, torch.float64).clone().requires_grad_(True)
    raw = params["raw_noise"].to(dev, torch.float64).clone().requires_grad_(True)
    phi_steps = phi_steps.to(torch.float64)
    n = phi_steps.shape[1]
    eye = torch.eye(n, dtype=torch.float64, device=phi_steps.device)
    phi = torch.einsum("l,lnc->nc", f, phi_steps)
    a = phi @ phi.T + noise_variance(raw) * eye
    y = y.to(torch.float64)
    z = probes.to(torch.float64)
    s = torch.linalg.solve(a.detach(), z.T)
    quad = y @ torch.linalg.solve(a, y)
    hutch = (s * (a @ z.T)).sum() / z.shape[0]
    g_f, g_raw = torch.autograd.grad(0.5 * (quad + hutch), (f, raw))
    return {"modulator": g_f.detach(), "raw_noise": g_raw.detach()}


def adam_first_step(grad: dict, lr: float, eps: float = 1e-8) -> dict:
    """Each leaf's change at Adam's first step (bias-corrected moments are
    g and g²): ``−lr · g / (|g| + eps)``."""
    return {k: -lr * g / (g.abs() + eps) for k, g in grad.items()}
