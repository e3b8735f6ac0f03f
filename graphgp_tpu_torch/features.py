"""Step-matrix feature layouts: dense, ELL-consolidated and stencil.

Counterpart of the ELL-consolidation and stencil parts of
``graphgp_tpu/features.py``:

* :class:`DenseFeatures`: dense (L, N, Nt) step matrices, the small-N regime
  of the exact GP; :func:`ell_to_dense` builds them from ELL.
* :class:`EllStepMatrices`: per-row deduplicated (cols, vals) step matrices
  with a fixed row capacity, built from a walk log by one sort and a
  segment sum (:func:`consolidate`).
* :class:`StencilStepMatrices`: on structured graphs (grid, ring, torus) every
  live ``col − row`` difference lies in a small global vocabulary of
  offsets, so ``M_l[i, i + off_s] = vals[l, s, i]`` and every product is a
  sum of shifted elementwise products. :func:`ell_to_stencil` converts with
  kernel K3.
* :class:`ContractedStencil`: the modulator folded into ``w (S, N)`` once per
  solve; its products are kernel K1.

The ELL products and the column-sorted transpose (the layouts of
unstructured graphs) are not ported yet: ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .cuda_kernels import stencil as k_stencil
from .cuda_kernels import stencil_build as k_build
from .walker import WalkLog

# Dead-lane sentinel: halted walks carry load 0. Sending their positions to
# int32-max merges every dead lane of a row into one group that sorts last,
# so the row capacity counts only distinct columns with nonzero mass.
DEAD_COL = 2**31 - 1

_ITEM_12 = "not ported yet (ROADMAP Queue 1 item 12: layouts for unstructured graphs)"


@dataclasses.dataclass(frozen=True)
class DenseFeatures:
    """Φ built from dense (L, N, Nt) step matrices: the small-N regime."""

    step_matrices: torch.Tensor  # (L, N, Nt)

    @property
    def num_nodes(self) -> int:
        return self.step_matrices.shape[1]

    @property
    def num_target_nodes(self) -> int:
        return self.step_matrices.shape[2]

    @property
    def max_walk_length(self) -> int:
        return self.step_matrices.shape[0]

    def _f(self, f) -> torch.Tensor:
        return torch.as_tensor(f, dtype=torch.float32, device=self.step_matrices.device)

    def phi(self, f) -> torch.Tensor:
        return torch.einsum("l,lij->ij", self._f(f), self.step_matrices)

    def matvec(self, f, v):
        return self.phi(f) @ v

    def rmatvec(self, f, v):
        return self.phi(f).T @ v

    def matvec_bm(self, f, v):
        return v @ self.phi(f).T

    def rmatvec_bm(self, f, v):
        return v @ self.phi(f)

    def rows(self, f, idx) -> torch.Tensor:
        """``Φ[idx, :]`` (R, Nt)."""
        return torch.einsum("l,lij->ij", self._f(f), self.step_matrices[:, idx, :])


@dataclasses.dataclass(frozen=True)
class EllStepMatrices:
    """Per-step sparse matrices in stacked ELL layout.

    cols: int32 (L, N, R), distinct visited-node ids per (step, start);
        padded slots point at node 0 with value 0.
    vals: float32 (L, N, R), summed loads / walks_per_node (the M_l entries).
    """

    cols: torch.Tensor
    vals: torch.Tensor
    num_target_nodes: int

    @property
    def max_walk_length(self) -> int:
        return self.cols.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.cols.shape[1]

    @property
    def row_capacity(self) -> int:
        return self.cols.shape[2]

    def nnz(self) -> torch.Tensor:
        return (self.vals != 0).sum()


@dataclasses.dataclass(frozen=True)
class EllFeatures:
    """ELL step matrices as a feature layout. Its Φ products (gathers and
    scatters over ELL rows) are not ported yet: ROADMAP Queue 1 item 12."""

    mats: EllStepMatrices

    @property
    def num_nodes(self) -> int:
        return self.mats.num_nodes

    @property
    def num_target_nodes(self) -> int:
        return self.mats.num_target_nodes

    @property
    def max_walk_length(self) -> int:
        return self.mats.max_walk_length


def _sorted_rows(cols: torch.Tensor, vals: torch.Tensor, w: int):
    """Rows of (cols, vals) with dead lanes sent to DEAD_COL, sorted by column."""
    c = torch.where(vals == 0.0, DEAD_COL, cols).reshape(-1, w)
    c, order = torch.sort(c, dim=-1)
    v = torch.gather(vals.reshape(-1, w), 1, order)
    is_new = torch.ones_like(c, dtype=torch.bool)
    is_new[:, 1:] = c[:, 1:] != c[:, :-1]
    return c, v, is_new


def _consolidate_rows(
    cols: torch.Tensor, vals: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate (cols, vals) pairs along the last axis into ≤capacity slots.

    cols int32 (..., W), vals float32 (..., W) → (int32 (..., R), float32
    (..., R), max_distinct): columns ascending, padded with (0, 0.0).
    ``max_distinct`` (a 0-d tensor) is the largest per-row count of distinct
    live columns; consolidation is lossless iff it is ≤ capacity.

    Segment totals are differences of a float64 running sum taken at each
    segment's last element: deterministic, and the float64 sum keeps the
    cancellation between signed loads of unrelated segments far below
    float32 resolution. Totals then round to float32 (the JAX package sums
    in float32, so values agree to summation order).
    """
    batch_shape = cols.shape[:-1]
    w = cols.shape[-1]
    req_capacity, capacity = capacity, min(capacity, w)
    c, v, is_new = _sorted_rows(cols, vals, w)
    b = c.shape[0]
    live = c != DEAD_COL
    max_distinct = (is_new & live).sum(dim=-1).max()
    is_last = torch.ones_like(is_new)
    is_last[:, :-1] = is_new[:, 1:]
    seg = torch.cumsum(is_new, dim=-1) - 1
    nseg = seg[:, -1:] + 1
    # scatter each segment's (col, running sum) into its slot; the non-last
    # elements and segments past the capacity go to a discarded column
    target = torch.where(is_last & (seg < capacity), seg, capacity)
    running = torch.cumsum(v.to(torch.float64), dim=-1)
    slot_cols = torch.zeros((b, capacity + 1), dtype=c.dtype, device=c.device)
    slot_cols.scatter_(1, target, c)
    slot_sum = torch.zeros((b, capacity + 1), dtype=torch.float64, device=c.device)
    slot_sum.scatter_(1, target, running)
    slot_cols, slot_sum = slot_cols[:, :capacity], slot_sum[:, :capacity]
    totals = torch.diff(slot_sum, dim=-1, prepend=torch.zeros_like(slot_sum[:, :1]))
    slot = torch.arange(capacity, device=c.device)[None, :]
    ok = (slot < nseg) & (slot_cols != DEAD_COL)
    out_cols = torch.where(ok, slot_cols, 0).to(torch.int32)
    out_vals = torch.where(ok, totals, 0.0).to(torch.float32)
    if req_capacity > capacity:
        pad = req_capacity - capacity
        out_cols = torch.nn.functional.pad(out_cols, (0, pad))
        out_vals = torch.nn.functional.pad(out_vals, (0, pad))
    return (
        out_cols.reshape(*batch_shape, req_capacity),
        out_vals.reshape(*batch_shape, req_capacity),
        max_distinct,
    )


def max_row_distinct(log: WalkLog) -> torch.Tensor:
    """0-d tensor: the largest count of distinct live visited nodes over all
    (step, start) rows, the minimal lossless ELL row capacity."""
    c, _, is_new = _sorted_rows(log.curs, log.loads, log.walks_per_node)
    return (is_new & (c != DEAD_COL)).sum(dim=-1).max()


def suggest_row_capacity(log: WalkLog, multiple: int = 8) -> int:
    """Max distinct live nodes over all rows, rounded up to ``multiple``."""
    w = log.walks_per_node
    cap = max(int(max_row_distinct(log)), 1)
    return min(((cap + multiple - 1) // multiple) * multiple, w)


def consolidate(
    log: WalkLog,
    capacity: int,
    num_target_nodes: Optional[int] = None,
    walks_per_node: Optional[int] = None,
) -> EllStepMatrices:
    """WalkLog → ELL step matrices (one sort + segment sum, on the log's device)."""
    _, n, w = log.curs.shape
    nt = num_target_nodes or n
    wpn = walks_per_node or w
    cols, vals, _ = _consolidate_rows(log.curs, log.loads / wpn, capacity)
    return EllStepMatrices(cols=cols, vals=vals, num_target_nodes=nt)


# ---------------------------------------------------------------------------
# Stencil layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StencilStepMatrices:
    """Step matrices as diagonal stencils: ``M_l[i, i + offsets[s]] =
    vals[l, s, i]``.

    ``offsets`` is a sorted numpy int array of raw ``col − row`` differences;
    wraparound entries of periodic graphs appear as raw differences (e.g.
    N − 1), exact under mod-N roll semantics: any (i, s) whose true column is
    not (i + off) mod N has vals = 0.
    """

    vals: torch.Tensor  # float32 (L, S, N)
    offsets: np.ndarray

    @property
    def max_walk_length(self) -> int:
        return self.vals.shape[0]

    @property
    def num_offsets(self) -> int:
        return self.vals.shape[1]

    @property
    def num_nodes(self) -> int:
        return self.vals.shape[2]


def offset_vocabulary(
    mats: EllStepMatrices, max_offsets: int = 256, chunk_rows: int = 0
) -> Optional[np.ndarray]:
    """The sorted set of live ``col − row`` differences, or None if it has
    more than ``max_offsets`` entries (unstructured graph: keep ELL).

    ``chunk_rows=0`` sizes node chunks to ~256M differences each."""
    l, n, r = mats.cols.shape
    if chunk_rows <= 0:
        chunk_rows = max((256 << 20) // (l * r), 1 << 12)
    dev = mats.cols.device
    vocab = torch.zeros((0,), dtype=torch.int64, device=dev)
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        rows = torch.arange(lo, hi, device=dev)[None, :, None]
        live = mats.vals[:, lo:hi] != 0.0
        d = (mats.cols[:, lo:hi].to(torch.int64) - rows)[live]
        vocab = torch.unique(torch.cat([vocab, torch.unique(d)]))
        if vocab.numel() > max_offsets:
            return None
    return vocab.cpu().numpy().astype(np.int32)


def ell_to_stencil(
    mats: EllStepMatrices, max_offsets: int = 256, chunk_rows: int = 0
) -> Optional[StencilStepMatrices]:
    """Convert ELL step matrices to stencil form with kernel K3, or None if
    the offset vocabulary is too large. One-time cost; cache the result."""
    if mats.num_target_nodes != mats.num_nodes:
        return None
    offsets = offset_vocabulary(mats, max_offsets, chunk_rows)
    if offsets is None:
        return None
    vals = k_build.ell_to_stencil(mats.cols, mats.vals, torch.from_numpy(offsets))
    return StencilStepMatrices(vals=vals, offsets=offsets)


@dataclasses.dataclass(frozen=True)
class StencilFeatures:
    """Φ over stencil step matrices: the structured-graph large-N layout.
    Its products go through :func:`contract`."""

    mats: StencilStepMatrices

    @property
    def num_nodes(self) -> int:
        return self.mats.num_nodes

    @property
    def num_target_nodes(self) -> int:
        return self.mats.num_nodes

    @property
    def max_walk_length(self) -> int:
        return self.mats.max_walk_length

    def to(self, device) -> "StencilFeatures":
        return StencilFeatures(
            StencilStepMatrices(self.mats.vals.to(device), self.mats.offsets)
        )


@dataclasses.dataclass(frozen=True)
class ContractedStencil:
    """``Φ = Σ_s diag(w_s) · shift(off_s)`` with the modulator pre-folded.

    w: float32 (S, N), ``w[s, i] = Σ_l f_l · vals[l, s, i]``.
    w_shift: float32 (S, N), ``roll(w[s], off_s)``, the transpose's table.
    Both are differentiable functions of the modulator, so gradients reach it
    through the forward and the transposed product alike. Each product hands
    the other's table to its backward for the gradient of v, so no backward
    builds a table.
    """

    w: torch.Tensor
    w_shift: torch.Tensor
    offsets: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.w.shape[1]

    @property
    def num_target_nodes(self) -> int:
        return self.w.shape[1]

    def matvec_bm(self, v: torch.Tensor) -> torch.Tensor:
        """``V @ Φᵀ``: Σ_s w_s ⊙ roll(v, −off_s). v: (B, N). Kernel K1."""
        return k_stencil.matvec_bm(self.w, v, self.offsets, self.w_shift)

    def rmatvec_bm(self, v: torch.Tensor) -> torch.Tensor:
        """``V @ Φ``: Σ_s roll(w_s ⊙ v, +off_s). v: (B, N). Kernel K1 on w_shift."""
        return k_stencil.rmatvec_bm(self.w_shift, v, self.offsets, self.w)

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Dense ``Φ[idx, :]`` (R, N): a small scatter of R·S entries."""
        n = self.num_nodes
        r = idx.shape[0]
        idx = idx.to(device=self.w.device, dtype=torch.int64)
        wr = self.w[:, idx]  # (S, R)
        offs = torch.as_tensor(self.offsets, dtype=torch.int64, device=self.w.device)
        cols = idx[None, :] + offs[:, None]
        ok = (cols >= 0) & (cols < n)
        row_ix = torch.arange(r, device=self.w.device)[None, :].expand_as(cols)
        flat = torch.where(ok, row_ix * n + cols, 0).reshape(-1)
        out = torch.zeros(r * n, dtype=torch.float32, device=self.w.device)
        out = out.index_add(0, flat, torch.where(ok, wr, 0.0).reshape(-1))
        return out.reshape(r, n)


def contract(feats, f: torch.Tensor) -> ContractedStencil:
    """Fold the modulator into the stencil operator, once per solve."""
    if not isinstance(feats, StencilFeatures):
        raise NotImplementedError(f"contract() on {type(feats).__name__}: {_ITEM_12}")
    vals = feats.mats.vals
    w = torch.einsum("l,lsn->sn", f.to(device=vals.device, dtype=torch.float32), vals)
    offsets = feats.mats.offsets
    w_shift = k_stencil.shifted_weights(w, k_stencil.center_offsets(offsets, w.shape[1]))
    return ContractedStencil(w=w, w_shift=w_shift, offsets=offsets)


def ell_to_dense(mats: EllStepMatrices) -> torch.Tensor:
    """(L, N, Nt) dense reconstruction, for tests and small N: one flat
    scatter-add (padded slots add 0 to column 0)."""
    l, n, r = mats.cols.shape
    nt = mats.num_target_nodes
    dev = mats.cols.device
    step_ix = torch.arange(l, device=dev)[:, None, None]
    row_ix = torch.arange(n, device=dev)[None, :, None]
    flat = ((step_ix * n + row_ix) * nt + mats.cols.to(torch.int64)).reshape(-1)
    out = torch.zeros(l * n * nt, dtype=torch.float32, device=dev)
    return out.index_add(0, flat, mats.vals.reshape(-1)).reshape(l, n, nt)


def stencil_is_periodic(mats: StencilStepMatrices) -> bool:
    """True iff any wrap-region stencil weight is nonzero (ring/torus graphs)."""
    n = mats.num_nodes
    total = mats.vals.new_zeros(())
    for s, off in enumerate(k_stencil.center_offsets(mats.offsets, n).tolist()):
        if off > 0:
            total = total + mats.vals[:, s, n - off :].abs().sum()
        elif off < 0:
            total = total + mats.vals[:, s, :-off].abs().sum()
    return bool(total > 0)
