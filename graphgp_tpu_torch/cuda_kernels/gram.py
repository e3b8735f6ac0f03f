"""K2, the fused masked-Gram CG, and its plain PyTorch version.

Solves ``(M K M + σ² M + (I − M)) x = b`` with ``K = Φ Φᵀ`` of a contracted
stencil operator and ``M = diag(mask)`` the 0/1 node mask of train nodes, for
up to 16 batch-major right-hand sides (B, N). One operator application is two
kernels:

* K2a (:func:`rmv_mask_cuda`, :func:`rmv_mask_plain`): ``t = Φᵀ(mask ⊙ v)``,
  ``t[b, i] = Σ_s w_shift[s, i] · (mask ⊙ v)[b, (i − off_s) mod N]``;
* K2b (:func:`mv_epilogue_cuda`, :func:`mv_epilogue_plain`):
  ``out = mask ⊙ (Φ t) + σ²·mask ⊙ v + (1 − mask) ⊙ v`` and the per-row dot
  ``⟨v, out⟩``, the CG denominator.

The solve is ``linalg``'s CG loop, the one every solve of the package runs,
on that operator.

Counterpart of ``graphgp_tpu/pallas_kernels/gram.py`` (``_rmv_mask``,
``_mv_epilogue``, ``_gram_cg_padded``, ``gram_cg``); the CUDA kernels are
``csrc/gram.cu``, whose header says what bounds them and why the padded
layout of the TPU kernels has no counterpart here. Both are K1's banded
product (``csrc/bands.cuh``) under the band plan of their offsets
(:func:`stencil.plan_bands`, which sorts them: the order they come in does
not matter). State stays (B, N) and wraparound is exact for every stencil.

CUDA tensors launch the kernels (or raise); CPU tensors take the plain
versions. There is no gradient: these are prediction solves.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..linalg import CGResult, _batched_cg_rows
from ..utils import profiling
from . import _build
from .stencil import MAX_BATCH, MAX_OFFSETS, _device_plan, center_offsets, matvec_plain

# Kernel launches since the last reset; chip_smoke.py reads them.
rmv_mask_launches = 0
mv_epilogue_launches = 0


def rmv_mask_plain(
    w_shift: torch.Tensor, mask: torch.Tensor, v: torch.Tensor, neg_offsets: Sequence[int]
) -> torch.Tensor:
    """K2a as a roll chain: the transposed product of ``mask ⊙ v`` through the
    pre-shifted weight table and the negated centred offsets."""
    return matvec_plain(w_shift, v * mask[None, :], neg_offsets)


def mv_epilogue_plain(
    w: torch.Tensor, t: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
    noise_var: torch.Tensor, offsets: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b in plain PyTorch → (out (B, N), ⟨v, out⟩ per row (B,))."""
    m = mask[None, :]
    out = m * matvec_plain(w, t, offsets) + (noise_var * m) * v + (1.0 - m) * v
    return out, (v * out).sum(dim=1)


def _check(name: str, w: torch.Tensor, mask: torch.Tensor, offsets, *states: torch.Tensor):
    tensors = (w, mask, *states)
    if not all(x.is_cuda and x.device == w.device for x in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if not all(x.dtype == torch.float32 for x in tensors):
        raise ValueError(f"{name}: all tensors must be float32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: all tensors must be contiguous")
    s, n = w.shape if w.dim() == 2 else (0, 0)
    shape = states[0].shape
    if (w.dim() != 2 or mask.shape != (n,) or len(shape) != 2 or shape[1] != n
            or any(x.shape != shape for x in states)):
        raise ValueError(
            f"{name}: bad shapes w{tuple(w.shape)} mask{tuple(mask.shape)} "
            + " ".join(str(tuple(x.shape)) for x in states)
        )
    b = shape[0]
    if s != len(offsets) or not 1 <= s <= MAX_OFFSETS or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"{name}: S={s} (offsets {len(offsets)}), B={b}")
    if any(abs(o) >= n for o in offsets):
        raise ValueError(f"{name}: offsets must be centred (|off| < N)")
    return s, b, n


def rmv_mask_cuda(
    w_shift: torch.Tensor, mask: torch.Tensor, v: torch.Tensor, neg_offsets: Tuple[int, ...]
) -> torch.Tensor:
    """Launch K2a once: w_shift (S, N), mask (N,), v (B ≤ 16, N), contiguous
    float32 on one CUDA device; ``neg_offsets`` the negated centred offsets."""
    global rmv_mask_launches
    s, b, n = _check("rmv_mask_cuda", w_shift, mask, neg_offsets, v)
    lib = _build.load()
    plan, table = _device_plan(tuple(int(o) for o in neg_offsets), v.device)
    t = torch.empty_like(v)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.gram_rmv_mask_f32(
            w_shift.data_ptr(), mask.data_ptr(), v.data_ptr(), t.data_ptr(), table.data_ptr(),
            table.numel(), s, plan.band_rows, b, n, plan.tile(b), plan.smem_bytes(b, mask=True),
            ctypes.c_void_p(stream),
        )
    rmv_mask_launches += 1
    _build.check(rc, "gram_rmv_mask_f32")
    return t


def mv_epilogue_partials_cuda(
    w: torch.Tensor, t: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
    noise_var: torch.Tensor, offsets: Tuple[int, ...],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2b once → (out (B, N), partials (B, ⌈N / tile⌉)): one partial
    sum of ``v·out`` per row and block of ``stencil.BandPlan.tile(B)``
    columns. ``noise_var`` is a one-element float32 tensor on the device
    (never read on the host)."""
    global mv_epilogue_launches
    s, b, n = _check("mv_epilogue_cuda", w, mask, offsets, v, t)
    if not (noise_var.is_cuda and noise_var.device == v.device
            and noise_var.dtype == torch.float32 and noise_var.numel() == 1):
        raise ValueError("mv_epilogue_cuda: noise_var must be one float32 on v's device")
    lib = _build.load()
    plan, table = _device_plan(tuple(int(o) for o in offsets), v.device)
    out = torch.empty_like(v)
    partials = torch.empty((b, lib.gram_num_blocks(b, n)), dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.gram_mv_epilogue_f32(
            w.data_ptr(), t.data_ptr(), mask.data_ptr(), v.data_ptr(), noise_var.data_ptr(),
            out.data_ptr(), partials.data_ptr(), table.data_ptr(), table.numel(), s,
            plan.band_rows, b, n, plan.tile(b), plan.smem_bytes(b), ctypes.c_void_p(stream),
        )
    mv_epilogue_launches += 1
    _build.check(rc, "gram_mv_epilogue_f32")
    return out, partials


def mv_epilogue_cuda(
    w: torch.Tensor, t: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
    noise_var: torch.Tensor, offsets: Tuple[int, ...],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2b once → (out (B, N), ⟨v, out⟩ (B,)). The kernel writes one
    partial sum per (row, block) in a fixed order; one ``torch.sum`` adds the
    blocks, so the dot is the same bits on every launch."""
    out, partials = mv_epilogue_partials_cuda(w, t, mask, v, noise_var, offsets)
    return out, partials.sum(dim=1)


def _plain_gram(operands, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One application of the plain K2a and K2b → ``(A v, ⟨v, A v⟩)``."""
    w, w_shift, offs, neg, nv, mask = operands
    return mv_epilogue_plain(w, rmv_mask_plain(w_shift, mask, v, neg), mask, v, nv, offs)


def _cuda_gram(operands, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K2a and one K2b launch → ``(A v, ⟨v, A v⟩)``."""
    w, w_shift, offs, neg, nv, mask = operands
    return mv_epilogue_cuda(w, rmv_mask_cuda(w_shift, mask, v, neg), mask, v, nv, offs)


def _solve(matvec, operands, b_rhs: torch.Tensor, tol, max_iters) -> CGResult:
    """``linalg``'s CG loop from ``x = 0`` on a K2 operator, whose dot is the
    step's denominator. It stays out of ``batched_cg``'s ``cg`` span and
    count: these solves are counted under ``gram_cg``."""
    with profiling.span("gram_cg"):
        res = _batched_cg_rows(matvec, operands, b_rhs, float(tol), int(max_iters), None, None)
        profiling.count("cg.iterations", res.iterations)
    return res


def _operands(phi, noise_var, mask, b_rhs):
    w = phi.w.detach().contiguous()
    w_shift = phi.w_shift.detach().contiguous()
    n = w.shape[1]
    offs = tuple(center_offsets(phi.offsets, n).tolist())
    neg = tuple(-o for o in offs)
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=w.device).detach().reshape(1)
    mask = mask.to(torch.float32).contiguous()
    b_rhs = b_rhs.to(torch.float32).contiguous()
    if b_rhs.dim() != 2 or not 1 <= b_rhs.shape[0] <= MAX_BATCH:
        raise ValueError(
            f"gram_cg: b_rhs must be (B ≤ {MAX_BATCH}, N), got {tuple(b_rhs.shape)}; "
            "solve larger batches in chunks (the systems are independent)"
        )
    return (w, w_shift, offs, neg, nv, mask), b_rhs


@torch.no_grad()
def gram_cg_plain(
    phi, noise_var, mask: torch.Tensor, b_rhs: torch.Tensor, *,
    tol: float = 1e-2, max_iters: int = 100,
) -> CGResult:
    """:func:`gram_cg` over the plain versions of K2a and K2b, on any device."""
    operands, b_rhs = _operands(phi, noise_var, mask, b_rhs)
    return _solve(_plain_gram, operands, b_rhs, tol, max_iters)


@torch.no_grad()
def gram_cg(
    phi, noise_var, mask: torch.Tensor, b_rhs: torch.Tensor, *,
    tol: float = 1e-2, max_iters: int = 100,
) -> CGResult:
    """Solve ``(M K M + σ²M + (I−M)) x = b`` for a ContractedStencil Φ.

    phi: ``features.ContractedStencil``. noise_var: σ² as a float or a 0-d
    tensor (kept on the device). mask: 0/1 float32 (N,). b_rhs: (B ≤ 16, N)
    batch-major full-space right-hand sides, zero off the mask (the identity
    block keeps whatever ``b`` holds there). Returns ``linalg.CGResult``:
    x (B, N), the iterations, and the relative residuals (B,).

    The JAX signature's ``periodic`` has no counterpart: the TPU kernels need
    it to decide whether to mirror edge columns into their pads, while these
    kernels index ``(i ± off) mod N`` directly, which is exact for periodic
    and aperiodic stencils alike.

    On CUDA tensors every operator application is one K2a and one K2b launch
    (a failed build or launch raises); CPU tensors take :func:`gram_cg_plain`.
    No gradient is defined.
    """
    if not b_rhs.is_cuda:
        return gram_cg_plain(phi, noise_var, mask, b_rhs, tol=tol, max_iters=max_iters)
    operands, b_rhs = _operands(phi, noise_var, mask, b_rhs)
    return _solve(_cuda_gram, operands, b_rhs, tol, max_iters)
