"""Iterative linear algebra for large-N GP inference.

Counterpart of ``graphgp_tpu/linalg.py``, batch-major: vectors are (B, N)
rows (``batched_cg`` and ``lanczos`` also take the JAX package's column-major
(N, B) with ``batch_axis=1``). Everything runs through a user-supplied
``matvec(carry, v)`` whose ``carry`` is a tuple of tensors and small dataclasses of tensors (such
as a contracted Φ operator). Solves and log-determinants are
``torch.autograd.Function``s with adjoint rules, so gradients reach the
tensors in the carry without differentiating through the iterations:

* ``cg_solve``: ``x = A⁻¹b``; backward solves ``u = A⁻¹g`` and takes the
  vector-Jacobian product of ``carry ↦ A(carry) x`` at ``−u``.
* ``slq_logdet``: stochastic Lanczos quadrature; backward solves the probes,
  ``d logdet = (1/P) Σ_p (A⁻¹z_p)ᵀ dA z_p``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from .utils import profiling

Matvec = Callable[[Any, torch.Tensor], torch.Tensor]


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor


def _column_major(fn):
    """A batch-major operator from a column-major one: ``v (B, N) ↦ fn(carry, vᵀ)ᵀ``."""
    return None if fn is None else (lambda carry, v: fn(carry, v.T).T)


def _as_rows(v: torch.Tensor) -> torch.Tensor:
    """(N,) → (1, N); column-major (N, B) → batch-major (B, N), contiguous."""
    return (v[None, :] if v.dim() == 1 else v.T).contiguous()


def batched_cg(
    matvec: Matvec,
    carry: Any,
    b: torch.Tensor,
    *,
    tol: float = 1e-2,
    max_iters: int = 100,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Matvec] = None,
    batch_axis: int = 0,
) -> CGResult:
    """Preconditioned conjugate gradients on B independent systems in lockstep.

    b: (N,), batch-major (B, N) with ``batch_axis=0`` (this package's
    layout), or column-major (N, B) with ``batch_axis=1`` (the JAX package's
    default). ``matvec(carry, v)`` and ``precond(carry, r)`` (which applies
    M⁻¹) take v in b's layout; a single vector reaches them as one row
    (1, N), or as one column (N, 1) with ``batch_axis=1``. ``matvec`` may
    return ``(A p, ⟨p, A p⟩)``, the per-row dot it formed itself, which the
    loop then takes as its step's denominator. Without ``x0`` the loop starts
    at ``x = 0``, ``r = b``, and applies the operator once an iteration.
    Systems whose relative residual ‖r‖/‖b‖ is at or below ``tol`` are frozen
    (step size 0) while the others go on; the loop ends when all have
    converged or after ``max_iters`` iterations.
    """
    if batch_axis == 1:
        res = batched_cg(
            _column_major(matvec), carry, _as_rows(b), tol=tol, max_iters=max_iters,
            x0=None if x0 is None else _as_rows(x0), precond=_column_major(precond),
        )
        if b.dim() == 1:
            return CGResult(res.x[0], res.iterations, res.residual_norm[0])
        return CGResult(res.x.T, res.iterations, res.residual_norm)
    with profiling.span("cg"):
        res = _batched_cg_rows(matvec, carry, b, tol, max_iters, x0, precond)
        profiling.count("cg.iterations", res.iterations)
        profiling.count("cg.solves")
    return res


def _batched_cg_rows(matvec, carry, b, tol, max_iters, x0, precond) -> CGResult:
    single = b.dim() == 1
    if single:
        b = b[None, :]
        x0 = None if x0 is None else x0[None, :]
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        ax = matvec(carry, x0)
        x, r = x0, b - (ax[0] if isinstance(ax, tuple) else ax)
    z = r if precond is None else precond(carry, r)
    p = z
    rz = (r * z).sum(dim=-1)
    # ‖r‖², the convergence test's: rz itself without a preconditioner
    rr = rz if precond is None else (r * r).sum(dim=-1)
    b_norm = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=1e-30)

    def residual(sq):
        return torch.sqrt(torch.clamp(sq, min=0.0)) / b_norm

    it = 0
    while it < max_iters:
        active = residual(rr) > tol
        with profiling.host_sync():
            converged = not bool(active.any())
        if converged:
            break
        ap = matvec(carry, p)
        if isinstance(ap, tuple):
            ap, denom = ap
        else:
            denom = (p * ap).sum(dim=-1)
        alpha = torch.where(denom != 0, rz / torch.where(denom != 0, denom, 1.0), 0.0)
        alpha = torch.where(active, alpha, 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = r if precond is None else precond(carry, r)
        rz_new = (r * z).sum(dim=-1)
        rr = rz_new if precond is None else (r * r).sum(dim=-1)
        beta = torch.where(rz != 0, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        p = z + beta[:, None] * p
        rz = rz_new
        it += 1
    res = residual(rr)
    if single:
        return CGResult(x[0], it, res[0])
    return CGResult(x, it, res)


# ---------------------------------------------------------------------------
# Carry flattening: the autograd Functions take the carry's tensors as inputs.
# ---------------------------------------------------------------------------


def _flatten(carry) -> Tuple[List[torch.Tensor], Callable[[List[torch.Tensor]], Any]]:
    """Tensors of a tuple carry (tensors, dataclasses of tensors, or other
    static values) and a function that rebuilds the carry from them."""
    leaves: List[torch.Tensor] = []
    parts = []
    for item in carry:
        if isinstance(item, torch.Tensor):
            parts.append(("t", len(leaves)))
            leaves.append(item)
        elif dataclasses.is_dataclass(item):
            slots = {}
            for f in dataclasses.fields(item):
                val = getattr(item, f.name)
                if isinstance(val, torch.Tensor):
                    slots[f.name] = len(leaves)
                    leaves.append(val)
            parts.append(("d", (item, slots)))
        else:
            parts.append(("s", item))

    def rebuild(ts: List[torch.Tensor]):
        out = []
        for kind, data in parts:
            if kind == "t":
                out.append(ts[data])
            elif kind == "d":
                item, slots = data
                out.append(dataclasses.replace(item, **{k: ts[i] for k, i in slots.items()}))
            else:
                out.append(data)
        return tuple(out)

    return leaves, rebuild


def _vjp_leaves(fn, leaves, needs, grad_output):
    """Gradients of ``fn(leaves)`` against ``grad_output`` for the leaves
    flagged in ``needs`` (None for the others)."""
    with torch.enable_grad():
        inputs = [
            t.detach().requires_grad_(True) if need else t.detach()
            for t, need in zip(leaves, needs)
        ]
        out = fn(inputs)
        wanted = [t for t, need in zip(inputs, needs) if need]
        grads = torch.autograd.grad(out, wanted, grad_outputs=grad_output, allow_unused=True)
    it = iter(grads)
    return [next(it) if need else None for need in needs]


class _CGSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, matvec, rebuild, tol, max_iters, b, *leaves):
        carry = rebuild(list(leaves))
        x = batched_cg(matvec, carry, b, tol=tol, max_iters=max_iters).x
        ctx.matvec, ctx.rebuild, ctx.tol, ctx.max_iters = matvec, rebuild, tol, max_iters
        ctx.save_for_backward(x, *leaves)
        return x

    @staticmethod
    def backward(ctx, g):
        x, *leaves = ctx.saved_tensors
        matvec, rebuild = ctx.matvec, ctx.rebuild
        u = batched_cg(
            matvec, rebuild(leaves), g.contiguous(), tol=ctx.tol, max_iters=ctx.max_iters
        ).x
        needs = [
            ctx.needs_input_grad[5 + k] and t.is_floating_point() for k, t in enumerate(leaves)
        ]
        grads = [None] * len(leaves)
        if any(needs):
            grads = _vjp_leaves(lambda ts: matvec(rebuild(ts), x), leaves, needs, -u)
        return (None, None, None, None, u, *grads)


def cg_solve(
    matvec: Matvec, carry, b: torch.Tensor, tol: float = 1e-4, max_iters: int = 200
) -> torch.Tensor:
    """``x = A(carry)⁻¹ b`` with adjoint-solve gradients (A symmetric)."""
    leaves, rebuild = _flatten(carry)
    return _CGSolve.apply(matvec, rebuild, tol, max_iters, b, *leaves)


def lanczos(
    matvec: Matvec,
    carry,
    v0: torch.Tensor,
    num_iters: int,
    *,
    reorthogonalize: bool = True,
    batch_axis: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lanczos tridiagonalization of symmetric A from start vectors v0, with
    full reorthogonalization against the stored basis (m is small).

    v0: (N,), batch-major rows (B, N), or column-major (N, B) with
    ``batch_axis=1``; ``matvec`` takes b's layout, as in :func:`batched_cg`.
    Returns (alphas (m, B), betas (m−1, B)), or (m,) and (m−1,) for one v0."""
    if batch_axis == 1 or v0.dim() == 1:
        mv = _column_major(matvec) if batch_axis == 1 else matvec
        rows = _as_rows(v0) if batch_axis == 1 else v0[None, :]
        alphas, betas = lanczos(mv, carry, rows, num_iters, reorthogonalize=reorthogonalize)
        return (alphas[:, 0], betas[:, 0]) if v0.dim() == 1 else (alphas, betas)
    with profiling.span("lanczos"):
        out = _lanczos_rows(matvec, carry, v0, num_iters, reorthogonalize)
        profiling.count("lanczos.iterations", num_iters)
    return out


def _lanczos_rows(matvec, carry, v0, num_iters, reorthogonalize):
    bsz = v0.shape[0]
    q = v0 / torch.clamp(torch.linalg.vector_norm(v0, dim=-1, keepdim=True), min=1e-30)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(bsz, dtype=v0.dtype, device=v0.device)
    basis = torch.zeros((num_iters,) + tuple(v0.shape), dtype=v0.dtype, device=v0.device)
    alphas, betas = [], []
    for k in range(num_iters):
        w = matvec(carry, q)
        alpha = (q * w).sum(dim=-1)
        w = w - alpha[:, None] * q - beta_prev[:, None] * q_prev
        if reorthogonalize:
            proj = torch.einsum("mbn,bn->mb", basis, w)
            w = w - torch.einsum("mbn,mb->bn", basis, proj)
        beta = torch.linalg.vector_norm(w, dim=-1)
        basis[k] = q
        q_prev, q = q, w / torch.clamp(beta[:, None], min=1e-30)
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1]


def _slq_from_tridiag(alphas, betas, norms_sq) -> torch.Tensor:
    """logdet ≈ mean_p ‖z_p‖² · Σ_i w_i log λ_i(T_p)."""
    m = alphas.shape[0]
    t = torch.diag_embed(alphas.T)
    if m > 1:
        off = torch.diag_embed(betas.T, offset=1)
        t = t + off + off.transpose(-1, -2)
    evals, evecs = torch.linalg.eigh(t)
    weights = evecs[:, 0, :] ** 2
    evals = torch.clamp(evals, min=1e-10)
    return (norms_sq * (weights * torch.log(evals)).sum(dim=-1)).mean()


class _SLQLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, matvec, rebuild, num_iters, tol, max_iters, probes, *leaves):
        carry = rebuild(list(leaves))
        alphas, betas = lanczos(matvec, carry, probes, num_iters)
        val = _slq_from_tridiag(alphas, betas, (probes * probes).sum(dim=-1))
        ctx.matvec, ctx.rebuild, ctx.tol, ctx.max_iters = matvec, rebuild, tol, max_iters
        ctx.save_for_backward(probes, *leaves)
        return val

    @staticmethod
    def backward(ctx, g):
        probes, *leaves = ctx.saved_tensors
        matvec, rebuild = ctx.matvec, ctx.rebuild
        needs = [
            ctx.needs_input_grad[6 + k] and t.is_floating_point() for k, t in enumerate(leaves)
        ]
        grads = [None] * len(leaves)
        if any(needs):
            solves = batched_cg(
                matvec, rebuild(leaves), probes, tol=ctx.tol, max_iters=ctx.max_iters
            ).x
            p = probes.shape[0]
            grads = _vjp_leaves(
                lambda ts: (solves * matvec(rebuild(ts), probes)).sum() / p, leaves, needs, g
            )
        return (None, None, None, None, None, None, *grads)


def slq_logdet(
    matvec: Matvec,
    carry,
    probes: torch.Tensor,
    num_lanczos_iters: int = 20,
    solver_tol: float = 1e-3,
    solver_max_iters: int = 200,
) -> torch.Tensor:
    """Stochastic Lanczos quadrature estimate of ``logdet A(carry)`` from
    Rademacher probe rows (P, N); gradients by probe solves."""
    leaves, rebuild = _flatten(carry)
    return _SLQLogdet.apply(
        matvec, rebuild, num_lanczos_iters, solver_tol, solver_max_iters, probes, *leaves
    )


def rademacher_probes(
    n: int, num_probes: int, generator: Optional[torch.Generator] = None, device="cpu"
) -> torch.Tensor:
    """(num_probes, n) rows of ±1."""
    bits = torch.randint(0, 2, (num_probes, n), generator=generator, device=device)
    return bits.to(torch.float32) * 2.0 - 1.0


# ---------------------------------------------------------------------------
# Small-N dense helpers.
# ---------------------------------------------------------------------------


def cholesky_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` given the lower Cholesky factor of A; b (n,) or (n, k)."""
    rhs = b[:, None] if b.dim() == 1 else b
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    x = torch.linalg.solve_triangular(chol.T, y, upper=True)
    return x[:, 0] if b.dim() == 1 else x


def safe_cholesky(a: torch.Tensor, jitter: float = 1e-6) -> torch.Tensor:
    """Lower Cholesky factor of ``a + jitter·I``, batched over leading axes.

    Where that matrix is not positive definite the factor is NaN on and below
    the diagonal (0 above), as ``jnp.linalg.cholesky`` returns it, and the NaN
    flows on instead of raising: an HMC trajectory that leaves the posterior's
    support then ends in a rejection. ``cholesky_ex`` leaves the info word on
    the device, so no call waits for the host.
    """
    n = a.shape[-1]
    chol, info = torch.linalg.cholesky_ex(
        a + jitter * torch.eye(n, dtype=a.dtype, device=a.device), check_errors=False
    )
    nan = torch.full_like(chol, float("nan")).tril()
    return torch.where((info == 0)[..., None, None], chol, nan)
