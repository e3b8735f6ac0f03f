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
from collections import OrderedDict
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

    On a card, with no preconditioner, no input that needs a gradient and an
    operator that declares itself :func:`capturable`, the loop runs as a
    CUDA graph of :data:`GRAPH_CHUNK` iterations with one host read a
    replay (:func:`_chunked_cg_rows`); the result is the same bits.
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
        if _graphable(matvec, carry, b, x0, precond):
            res = _chunked_cg_rows(matvec, carry, b, tol, max_iters, x0, GRAPH_CHUNK,
                                   graphed=True)
            profiling.count("cg.graph_solves")
        else:
            res = _batched_cg_rows(matvec, carry, b, tol, max_iters, x0, precond)
        profiling.count("cg.iterations", res.iterations)
        profiling.count("cg.solves")
    return res


class _CGState(NamedTuple):
    """The loop's carry: iterate, residual, direction, ⟨r, z⟩ and ‖r‖² (rows)."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rr: torch.Tensor


def _cg_start(matvec, carry, b, x0, precond) -> Tuple[_CGState, torch.Tensor]:
    """The state at ``x0`` (x = 0, r = b without one, and no product) and ‖b‖."""
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        ax = matvec(carry, x0)
        x, r = x0, b - (ax[0] if isinstance(ax, tuple) else ax)
    z = r if precond is None else precond(carry, r)
    rz = (r * z).sum(dim=-1)
    # ‖r‖², the convergence test's: rz itself without a preconditioner
    rr = rz if precond is None else (r * r).sum(dim=-1)
    b_norm = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=1e-30)
    return _CGState(x, r, z, rz, rr), b_norm


def _residual(rr, b_norm):
    return torch.sqrt(torch.clamp(rr, min=0.0)) / b_norm


def _cg_step(matvec, carry, s: _CGState, active, precond) -> _CGState:
    """One iteration; rows not ``active`` take step size 0, so their x and r
    stay the same bits."""
    ap = matvec(carry, s.p)
    if isinstance(ap, tuple):
        ap, denom = ap
    else:
        denom = (s.p * ap).sum(dim=-1)
    alpha = torch.where(denom != 0, s.rz / torch.where(denom != 0, denom, 1.0), 0.0)
    alpha = torch.where(active, alpha, 0.0)
    x = s.x + alpha[:, None] * s.p
    r = s.r - alpha[:, None] * ap
    z = r if precond is None else precond(carry, r)
    rz = (r * z).sum(dim=-1)
    rr = rz if precond is None else (r * r).sum(dim=-1)
    beta = torch.where(s.rz != 0, rz / torch.where(s.rz != 0, s.rz, 1.0), 0.0)
    return _CGState(x, r, z + beta[:, None] * s.p, rz, rr)


def _rows_result(x, iterations, res, single) -> CGResult:
    return CGResult(x[0], iterations, res[0]) if single else CGResult(x, iterations, res)


def _batched_cg_rows(matvec, carry, b, tol, max_iters, x0, precond) -> CGResult:
    """The loop with one host read of the convergence flag an iteration."""
    single = b.dim() == 1
    if single:
        b = b[None, :]
        x0 = None if x0 is None else x0[None, :]
    s, b_norm = _cg_start(matvec, carry, b, x0, precond)
    it = 0
    while it < max_iters:
        active = _residual(s.rr, b_norm) > tol
        with profiling.host_sync():
            converged = not bool(active.any())
        if converged:
            break
        s = _cg_step(matvec, carry, s, active, precond)
        it += 1
    return _rows_result(s.x, it, _residual(s.rr, b_norm), single)


# ---------------------------------------------------------------------------
# The loop in chunks of k iterations, one host read a chunk; on a card each
# chunk is a replay of one CUDA graph.
# ---------------------------------------------------------------------------

# iterations a replay: the rgg's solves take ~60, the grid's ~4
GRAPH_CHUNK = 8
_GRAPHS_KEPT = 16


def capturable(matvec: Matvec) -> Matvec:
    """Declare that ``matvec``'s product is a fixed chain of launches with no
    host read, so that :func:`batched_cg` may replay it from a CUDA graph.
    The function is kept as the graph's key: declare a module-level one."""
    matvec.capturable = True
    return matvec


def _graphable(matvec, carry, b, x0, precond) -> bool:
    if precond is not None or not b.is_cuda or not getattr(matvec, "capturable", False):
        return False
    if _carry_key(carry) is None:
        return False
    if torch.is_grad_enabled():
        inputs = [b, x0] + [t for t in carry if isinstance(t, torch.Tensor)]
        return not any(t is not None and t.requires_grad for t in inputs)
    return True


def _carry_key(carry):
    """Shapes and dtypes of a carry of tensors, Nones and Python numbers
    (which a graph holds as constants), or None for any other carry."""
    key = []
    for item in carry:
        if isinstance(item, torch.Tensor):
            key.append((tuple(item.shape), item.dtype, item.device))
        elif item is None or isinstance(item, (bool, int, float)):
            key.append(item)
        else:
            return None
    return tuple(key)


def _cg_chunk(matvec, carry, s: _CGState, iters, b_norm, k, tol, max_iters):
    """k iterations with no host read and no preconditioner. ``iters`` (an
    int64 scalar) counts the iterations in which some row was live: its
    residual above ``tol`` and fewer than ``max_iters`` iterations run. A
    row that is not live takes α = 0, so its x and r stay the same bits and
    it stays not live; once no row is live the rest of the chunk changes
    neither, and x, the residual and ``iters`` are those of the loop that
    stops there. Returns the state, ``iters`` and ``[any row live, iters]``."""
    for _ in range(k):
        active = (_residual(s.rr, b_norm) > tol) & (iters < max_iters)
        s = _cg_step(matvec, carry, s, active, None)
        iters = iters + active.any()
    live = ((_residual(s.rr, b_norm) > tol) & (iters < max_iters)).any()
    return s, iters, torch.stack([live.to(torch.int64), iters])


def _chunked_cg_rows(matvec, carry, b, tol, max_iters, x0, k, graphed=False) -> CGResult:
    """The loop (no preconditioner) in chunks of k iterations, with one host
    read of ``[any row live, iterations]`` a chunk: the one-iteration loop's
    x, residual and iterations, bit for bit. ``graphed``: each chunk is a
    replay of a CUDA graph (:class:`_ChunkGraph`)."""
    single = b.dim() == 1
    if single:
        b = b[None, :]
        x0 = None if x0 is None else x0[None, :]
    s, b_norm = _cg_start(matvec, carry, b, x0, None)
    iters = torch.zeros((), dtype=torch.int64, device=b.device)
    if graphed:
        graph = _ChunkGraph.get(matvec, carry, s, iters, b_norm, k, tol, max_iters)
        graph.load(carry, s, iters, b_norm)
        run = graph.replay
    else:
        def run():
            nonlocal s, iters
            s, iters, status = _cg_chunk(matvec, carry, s, iters, b_norm, k, tol, max_iters)
            return status
    live = True
    while live:
        status = run()
        with profiling.host_sync():
            live, n = status.tolist()
    if graphed:
        s = graph.state()
    return _rows_result(s.x, n, _residual(s.rr, b_norm), single)


class _ChunkGraph:
    """:func:`_cg_chunk` captured as one CUDA graph on static copies of the
    carry's tensors, the state, the iteration count and ‖b‖, which a replay
    advances in place. One is kept per (operator, carry shapes, b's shape and
    dtype, tol, max_iters, k), the last :data:`_GRAPHS_KEPT` of them."""

    _kept: "OrderedDict[tuple, _ChunkGraph]" = OrderedDict()

    @classmethod
    def get(cls, matvec, carry, s, iters, b_norm, k, tol, max_iters) -> "_ChunkGraph":
        key = (matvec, _carry_key(carry), tuple(s.x.shape), s.x.dtype, tol, max_iters, k)
        graph = cls._kept.pop(key, None)
        if graph is None:
            graph = cls(matvec, carry, s, iters, b_norm, k, tol, max_iters)
            profiling.count("cg.graph_captures")
        cls._kept[key] = graph
        while len(cls._kept) > _GRAPHS_KEPT:
            cls._kept.popitem(last=False)
        return graph

    def __init__(self, matvec, carry, s, iters, b_norm, k, tol, max_iters):
        leaves, rebuild = _flatten(carry)
        self._leaves = [t.detach().clone() for t in leaves]
        self._state = _CGState(*(t.detach().clone() for t in s))
        self._iters = iters.clone()
        self._b_norm = b_norm.detach().clone()
        static = rebuild(self._leaves)

        def body():
            out, n, status = _cg_chunk(matvec, static, self._state, self._iters, self._b_norm,
                                       k, tol, max_iters)
            for dst, src in zip(self._state + (self._iters,), out + (n,)):
                dst.copy_(src)
            return status

        with torch.no_grad():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            # warm-up launches outside the capture; its counts are dropped
            with torch.cuda.stream(side), profiling.tally():
                body()
            torch.cuda.current_stream().wait_stream(side)
            self._graph = torch.cuda.CUDAGraph()
            # the backward pass's solves run on autograd's own thread
            with profiling.tally() as self._counts, torch.cuda.graph(
                    self._graph, capture_error_mode="thread_local"):
                self._status = body()

    def load(self, carry, s, iters, b_norm) -> None:
        leaves, _ = _flatten(carry)
        for dst, src in zip(self._leaves + list(self._state) + [self._iters, self._b_norm],
                            leaves + list(s) + [iters, b_norm]):
            dst.copy_(src)

    def replay(self) -> torch.Tensor:
        """One chunk; the operator's own counts of k products are added."""
        self._graph.replay()
        for name, n in self._counts.items():
            profiling.count(name, n)
        return self._status

    def state(self) -> _CGState:
        return _CGState(*(t.clone() for t in self._state))


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
