"""K1, the stencil product, its weight gradient, and their plain versions.

``out[b, i] = Σ_s w[s, i] · v[b, (i + off_s) mod N]`` for w (S, N) and
v (B, N): the batch-major ``V @ Φᵀ`` of a contracted stencil operator.
Counterpart of ``graphgp_tpu/pallas_kernels/stencil.py``; the CUDA kernels
are ``csrc/stencil.cu`` (its header says what bounds them and why they are
built as they are). :func:`plan_bands` is the kernels' band planner.

The transpose ``V @ Φ`` is the same product under the pre-shifted weight
table ``shifted_weights(w)`` with negated offsets, so one kernel serves both.
Its gradient is :class:`_StencilMatvec`, which takes the other product's
table as an input it does not differentiate: ``dv`` is the product with that
table under the negated offsets (``shifted_weights(w_shift, −offs) == w``),
``dw[s, i] = Σ_b g[b, i] · v[b, (i + off_s) mod N]`` the second kernel. No
table is built in a backward.

CUDA tensors launch the kernels (or raise); CPU tensors take the plain
versions, the roll chain of ``ContractedStencil.matvec_bm`` and the roll
reduction ``_dw_matvec`` of the JAX package.
"""
from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build

MAX_BATCH = 16
MAX_OFFSETS = 256
# The kernels' tiling (csrc/bands.cuh: tile_for, kPad, kMaxBandRows): a
# block owns tile_for(B) columns; a band's window row holds the tile plus
# WINDOW_PAD floats, room for its spread and the 16-byte copies' alignment
# shift of up to 3.
WINDOW_PAD = 64
SPREAD_LIMIT = WINDOW_PAD - 4
BAND_OFFSETS = 16

# Kernel launches since the last reset; chip_smoke.py reads them.
launches = 0
dw_launches = 0


def center_offsets(offsets, n: int) -> np.ndarray:
    """Map roll offsets to their centred equivalents mod n (ring wraparound
    n−1 → −1)."""
    off = np.asarray(offsets, np.int64) % n
    return np.where(off > n // 2, off - n, off).astype(np.int64)


def shifted_weights(w: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """``shift(w)[s] = roll(w[s], off_s)``: the transpose's weight table.
    Differentiable; built once per contraction, never inside a solver loop."""
    return torch.stack([torch.roll(w[s], int(o), dims=-1) for s, o in enumerate(offsets)])


def matvec_plain(w: torch.Tensor, v: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """The roll chain: ``Σ_s w[s] ⊙ roll(v, −off_s)``."""
    out = torch.zeros_like(v, dtype=torch.float32)
    for s, off in enumerate(offsets):
        out = out + w[s][None, :] * torch.roll(v, -int(off), dims=-1)
    return out


def _dw_matvec(v: torch.Tensor, g: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """``dw[s, i] = Σ_b g[b, i] · v[b, (i + off_s) mod n]``: the gradient
    kernel's plain version."""
    return torch.stack(
        [(g * torch.roll(v, -int(o), dims=-1)).sum(dim=0) for o in offsets]
    )


# ---------------------------------------------------------------------------
# The band planner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Offsets grouped into bands for the kernels: each band a run of sorted
    offsets whose spread (max − min) is at most ``SPREAD_LIMIT``, of at most
    ``BAND_OFFSETS`` offsets. A block stages one band's window of v at a time.

    table: int32 ``[nb | (lo, begin, end) × nb | (s, off_s − lo) × S]``, the
        entries sorted by offset, ``begin:end`` a band's entries, ``s`` the
        row of the weight table in the caller's order.
    """

    table: np.ndarray
    num_bands: int
    band_rows: int   # most offsets in one band: the rows of w a stage holds

    def bands(self):
        """[(lo, [(s, off_s), ...]), ...] in the kernels' order."""
        nb = self.num_bands
        ent = self.table[1 + 3 * nb:].reshape(-1, 2)
        out = []
        for k in range(nb):
            lo, begin, end = (int(x) for x in self.table[1 + 3 * k: 4 + 3 * k])
            out.append((lo, [(int(s), lo + int(d)) for s, d in ent[begin:end]]))
        return out

    @staticmethod
    def tile(batch: int) -> int:
        """Columns a block owns at ``batch`` rows: 256 up to 12 rows, where a
        wide tile amortises each band's staging, 128 above, where half the
        shared memory lets twice as many blocks share an SM."""
        return 256 if batch <= 12 else 128

    def smem_bytes(self, batch: int, weights: bool = True, mask: bool = False) -> int:
        """Dynamic shared memory of one block at ``batch`` rows: two stages of
        the (batch, tile + WINDOW_PAD) window (one more row for K2a's mask),
        and for a product ``band_rows`` rows of w, then the table."""
        tile = self.tile(batch)
        stage = (batch + mask) * (tile + WINDOW_PAD) + (self.band_rows * tile if weights else 0)
        return 4 * (2 * stage + self.table.size)


def plan_bands(offsets: Sequence[int]) -> BandPlan:
    """Band plan of centred offsets (|off| < N), S ≤ 256, any order; equal
    offsets may repeat. Greedy over the sorted offsets: a band closes when the
    next offset is more than SPREAD_LIMIT past its first or it holds
    BAND_OFFSETS. Far-apart offsets each get a band of their own."""
    offs = np.asarray(offsets, np.int64)
    if not 1 <= offs.size <= MAX_OFFSETS:
        raise ValueError(f"plan_bands: S={offs.size} out of 1..{MAX_OFFSETS}")
    bands, entries = [], []
    for e, s in enumerate(np.argsort(offs, kind="stable")):
        o = int(offs[s])
        if not bands or o - bands[-1][0] > SPREAD_LIMIT or e - bands[-1][1] == BAND_OFFSETS:
            bands.append([o, e, e])
        bands[-1][2] = e + 1
        entries += [int(s), o - bands[-1][0]]
    table = np.asarray([len(bands), *(x for b in bands for x in b), *entries], np.int32)
    return BandPlan(table=table, num_bands=len(bands),
                    band_rows=max(end - begin for _, begin, end in bands))


@lru_cache(maxsize=64)
def _device_plan(offsets: Tuple[int, ...], device: torch.device):
    # Cached: a host-to-device copy per launch would stall the host on the
    # stream's queued work. K1, dw, K2a and K2b all take their plans here.
    plan = plan_bands(offsets)
    return plan, torch.from_numpy(plan.table).to(device)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(what: str, offsets, *tensors) -> Tuple[int, int]:
    if not all(t.is_cuda and t.device == tensors[0].device for t in tensors):
        raise ValueError(f"{what}: inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what}: inputs must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    n = tensors[0].shape[-1]
    if any(t.dim() != 2 or t.shape[1] != n for t in tensors):
        raise ValueError(f"{what}: bad shapes {[tuple(t.shape) for t in tensors]}")
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{what}: S={len(offsets)} offsets")
    if any(abs(o) >= n for o in offsets):
        raise ValueError(f"{what}: offsets must be centred (|off| < N)")
    return len(offsets), n


def stencil_matvec_cuda(w: torch.Tensor, v: torch.Tensor, offsets: Tuple[int, ...]) -> torch.Tensor:
    """Launch K1 once: w (S, N), v (B ≤ 16, N), both contiguous float32 on
    one CUDA device; ``offsets`` centred (|off| < N)."""
    global launches
    s, n = _check("stencil_matvec_cuda", offsets, w, v)
    b = v.shape[0]
    if w.shape[0] != s or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"stencil_matvec_cuda: w{tuple(w.shape)}, {s} offsets, B={b}")
    lib = _build.load()
    plan, table = _device_plan(tuple(int(o) for o in offsets), w.device)
    out = torch.empty_like(v)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.stencil_matvec_f32(
            w.data_ptr(), v.data_ptr(), out.data_ptr(), table.data_ptr(), table.numel(),
            s, plan.band_rows, b, n, plan.tile(b), plan.smem_bytes(b), ctypes.c_void_p(stream),
        )
    launches += 1
    _build.check(rc, "stencil_matvec_f32")
    return out


def stencil_dw_cuda(v: torch.Tensor, g: torch.Tensor, offsets: Tuple[int, ...]) -> torch.Tensor:
    """Launch the gradient kernel once: ``dw[s, i] = Σ_b g[b, i] ·
    v[b, (i + off_s) mod N]`` for v, g (B ≤ 16, N) contiguous float32 on one
    CUDA device; ``offsets`` centred (|off| < N)."""
    global dw_launches
    s, n = _check("stencil_dw_cuda", offsets, v, g)
    b = v.shape[0]
    if g.shape[0] != b or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"stencil_dw_cuda: v{tuple(v.shape)} g{tuple(g.shape)}")
    dw = torch.empty((s, n), dtype=torch.float32, device=v.device)
    lib = _build.load()
    plan, table = _device_plan(tuple(int(o) for o in offsets), v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.stencil_dw_f32(
            v.data_ptr(), g.data_ptr(), dw.data_ptr(), table.data_ptr(), table.numel(),
            s, b, n, plan.tile(b), plan.smem_bytes(b, weights=False), ctypes.c_void_p(stream),
        )
    dw_launches += 1
    _build.check(rc, "stencil_dw_f32")
    return dw


def _product(w: torch.Tensor, v: torch.Tensor, offsets: Tuple[int, ...]) -> torch.Tensor:
    """One product on w's device: the kernel in ≤16-row launches on CUDA,
    the plain version on the CPU."""
    if not w.is_cuda:
        return matvec_plain(w, v, offsets)
    w, v = w.contiguous(), v.contiguous()
    if v.shape[0] <= MAX_BATCH:
        return stencil_matvec_cuda(w, v, offsets)
    return torch.cat(
        [stencil_matvec_cuda(w, v[i : i + MAX_BATCH], offsets)
         for i in range(0, v.shape[0], MAX_BATCH)]
    )


def dw_matvec(v: torch.Tensor, g: torch.Tensor, offsets: Tuple[int, ...]) -> torch.Tensor:
    """``dw[s, i] = Σ_b g[b, i] · v[b, (i + off_s) mod N]`` on v's device:
    the gradient kernel on CUDA (≤16-row launches, their tables added in
    order), the plain version on the CPU."""
    if not v.is_cuda:
        return _dw_matvec(v, g, offsets)
    v, g = v.contiguous(), g.contiguous()
    dw = stencil_dw_cuda(v[:MAX_BATCH], g[:MAX_BATCH], offsets)
    for i in range(MAX_BATCH, v.shape[0], MAX_BATCH):
        dw = dw + stencil_dw_cuda(v[i : i + MAX_BATCH], g[i : i + MAX_BATCH], offsets)
    return dw


class _StencilMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, v, partner, offsets):
        ctx.save_for_backward(v, partner)
        ctx.offsets = offsets
        return _product(w, v, offsets)

    @staticmethod
    def backward(ctx, g):
        v, partner = ctx.saved_tensors
        offs = ctx.offsets
        dw = dv = None
        if ctx.needs_input_grad[1]:
            # the transposed product: the partner table under −offsets
            dv = _product(partner, g, tuple(-o for o in offs))
        if ctx.needs_input_grad[0]:
            dw = dw_matvec(v, g, offs)
        return dw, dv, None, None


def stencil_matvec(
    w: torch.Tensor, v: torch.Tensor, offsets: Sequence[int], partner: torch.Tensor
) -> torch.Tensor:
    """Differentiable ``out[b, i] = Σ_s w[s, i] · v[b, (i + off_s) mod N]``
    for centred offsets. ``partner`` is ``shifted_weights(w, offsets)``, the
    table of the transposed product; it carries no gradient from here."""
    return _StencilMatvec.apply(w, v, partner, tuple(int(o) for o in offsets))


def matvec_bm(w: torch.Tensor, v: torch.Tensor, offsets, w_shift: torch.Tensor) -> torch.Tensor:
    """``V @ Φᵀ`` (B, N) → (B, N) for raw (uncentred) stencil offsets;
    ``w_shift = shifted_weights(w, ·)`` serves the gradient of v."""
    n = w.shape[1]
    return stencil_matvec(w, v, center_offsets(offsets, n).tolist(), w_shift)


def rmatvec_bm(w_shift: torch.Tensor, v: torch.Tensor, offsets, w: torch.Tensor) -> torch.Tensor:
    """``V @ Φ`` through the pre-shifted weight table (see shifted_weights):
    rmatvec(w, ·, offs) ≡ matvec(shift(w), ·, −offs); ``w`` serves the
    gradient of v."""
    n = w_shift.shape[1]
    return stencil_matvec(w_shift, v, (-center_offsets(offsets, n)).tolist(), w)
