"""Step-matrix feature layouts: dense, walk-log, ELL-consolidated and stencil.

Counterpart of ``graphgp_tpu/features.py``:

* :class:`DenseFeatures`: dense (L, N, Nt) step matrices, the small-N regime
  of the exact GP; :func:`ell_to_dense` builds them from ELL.
* :class:`LogFeatures`: Φ straight off the walk log (``log_phi_*``), the
  layout of the multi-device solve.
* :class:`EllStepMatrices`: per-row deduplicated (cols, vals) step matrices
  with a fixed row capacity, built from a walk log by one sort and a
  segment sum (:func:`consolidate`). :class:`EllFeatures` is the layout of
  unstructured large graphs: its forward products sum each row's gathered
  entries of the vector, one step at a time.
* :class:`CscStepMatrices`: the column-sorted transpose of the ELL
  (:func:`transpose_ell`, attached by :func:`with_transpose`). With it the
  transposed product gathers too and reduces each column in a fixed order,
  so no product of an unstructured graph scatters: on CUDA a scatter-add
  adds floats by atomics in no fixed order, and two calls would differ.
* :class:`StencilStepMatrices`: on structured graphs (grid, ring, torus) every
  live ``col − row`` difference lies in a small global vocabulary of
  offsets, so ``M_l[i, i + off_s] = vals[l, s, i]`` and every product is a
  sum of shifted elementwise products. :func:`ell_to_stencil` converts with
  kernel K3.
* :func:`contract` binds the modulator: :class:`ContractedStencil` folds it
  into ``w (S, N)`` once per solve (its products are kernel K1);
  :class:`ContractedFeatures` binds it to an ELL or dense layout.

The ELL and transposed products are plain PyTorch operations on every
device: the JAX package computes them in XLA, with no Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .cuda_kernels import stencil as k_stencil
from .cuda_kernels import stencil_build as k_build
from .linalg import _as_rows
from .utils import profiling
from .walker import WalkLog

# Dead-lane sentinel: halted walks carry load 0. Sending their positions to
# int32-max merges every dead lane of a row into one group that sorts last,
# so the row capacity counts only distinct columns with nonzero mass.
DEAD_COL = 2**31 - 1



def _f32(f, device) -> torch.Tensor:
    """The modulator as float32 on ``device``, keeping its autograd graph."""
    if isinstance(f, torch.Tensor):
        return f.to(device=device, dtype=torch.float32)
    return torch.as_tensor(f, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Walk-log products: Φ = Σ_l f_l M_l straight from the walk log, without
# consolidation. The forward products gather; the transposed ones scatter-add
# (``index_add``), which on CUDA adds floats by atomics in no fixed order, so
# two calls agree to float32 summation order, not bit for bit.
# ---------------------------------------------------------------------------


def _log_weights(log: WalkLog, modulator, device) -> torch.Tensor:
    """(L, N, W): ``f_l · load / W``."""
    f = _f32(modulator, device)
    return (log.loads / log.walks_per_node) * f[:, None, None]


def log_phi_matvec(log: WalkLog, modulator, v: torch.Tensor) -> torch.Tensor:
    """``Φ @ v``; v (Nt,) or (Nt, B) → (N,) or (N, B)."""
    weights = _log_weights(log, modulator, v.device)
    gathered = v[log.curs]  # (L, N, W) or (L, N, W, B)
    if v.dim() == 1:
        return torch.einsum("lnw,lnw->n", weights, gathered)
    return torch.einsum("lnw,lnwb->nb", weights, gathered)


def log_phi_rmatvec(
    log: WalkLog, modulator, v: torch.Tensor, num_target_nodes: int
) -> torch.Tensor:
    """``Φᵀ @ v``: a scatter-add of ``f_l · load · v[start]`` onto the visited
    nodes; v (N,) or (N, B) → (Nt,) or (Nt, B)."""
    weights = _log_weights(log, modulator, v.device)
    idx = log.curs.reshape(-1)
    if v.dim() == 1:
        vals = (weights * v[None, :, None]).reshape(-1)
        out = torch.zeros(num_target_nodes, dtype=torch.float32, device=v.device)
        return out.index_add(0, idx, vals)
    b = v.shape[1]
    vals = (weights[..., None] * v[None, :, None, :]).reshape(-1, b)
    return torch.zeros((num_target_nodes, b), dtype=torch.float32, device=v.device).index_add(
        0, idx, vals)


def log_phi_rows(
    log: WalkLog, modulator, rows: torch.Tensor, num_target_nodes: int
) -> torch.Tensor:
    """Dense rows ``Φ[rows, :]`` (R, Nt), for K_test,train style blocks."""
    dev = log.curs.device
    rows = torch.as_tensor(rows, device=dev).to(torch.int64)
    weights = _log_weights(log, modulator, dev)[:, rows, :]  # (L, R, W)
    curs = log.curs[:, rows, :].to(torch.int64)
    r = rows.shape[0]
    flat = (torch.arange(r, device=dev)[None, :, None] * num_target_nodes + curs).reshape(-1)
    out = torch.zeros(r * num_target_nodes, dtype=torch.float32, device=dev)
    return out.index_add(0, flat, weights.reshape(-1)).reshape(r, num_target_nodes)


def log_phi_matvec_bm(log: WalkLog, modulator, v: torch.Tensor) -> torch.Tensor:
    """``V @ Φᵀ`` straight from the walk log: (B, Nt) → (B, N)."""
    weights = _log_weights(log, modulator, v.device)
    return torch.einsum("lnw,blnw->bn", weights, v[:, log.curs])


def log_phi_rmatvec_bm(
    log: WalkLog, modulator, v: torch.Tensor, num_target_nodes: int
) -> torch.Tensor:
    """``V @ Φ``: a scatter-add onto the visited nodes, (B, N) → (B, Nt)."""
    weights = _log_weights(log, modulator, v.device)
    b = v.shape[0]
    vals = weights[None] * v[:, None, :, None]  # (B, L, N, W)
    return torch.zeros((b, num_target_nodes), dtype=torch.float32, device=v.device).index_add(
        1, log.curs.reshape(-1), vals.reshape(b, -1))


@dataclasses.dataclass(frozen=True)
class LogFeatures:
    """Φ straight off the walk log: no consolidation cost; best when only a
    few Φ products are needed, and the layout of the multi-device solve
    (``shard.distributed_gram_solve``)."""

    log: WalkLog
    num_target_nodes: int

    @property
    def num_nodes(self) -> int:
        return self.log.num_nodes

    @property
    def max_walk_length(self) -> int:
        return self.log.max_walk_length

    def matvec(self, f, v):
        return log_phi_matvec(self.log, f, v)

    def rmatvec(self, f, v):
        return log_phi_rmatvec(self.log, f, v, self.num_target_nodes)

    def matvec_bm(self, f, v):
        return log_phi_matvec_bm(self.log, f, v)

    def rmatvec_bm(self, f, v):
        return log_phi_rmatvec_bm(self.log, f, v, self.num_target_nodes)

    def rows(self, f, idx):
        return log_phi_rows(self.log, f, idx, self.num_target_nodes)

    def to(self, device) -> "LogFeatures":
        return LogFeatures(WalkLog(self.log.curs.to(device), self.log.loads.to(device)),
                           self.num_target_nodes)

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

    def to(self, device) -> "EllStepMatrices":
        return EllStepMatrices(self.cols.to(device), self.vals.to(device), self.num_target_nodes)


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
    distinct = max_row_distinct(log)
    with profiling.host_sync():
        cap = max(int(distinct), 1)
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
# ELL products. Batch-major: matvec_bm(f, V) = V Φᵀ, (B, Nt) → (B, N);
# rmatvec_bm(f, V) = V Φ, (B, N) → (B, Nt).
# ---------------------------------------------------------------------------


def _bag_sums(idx: torch.Tensor, w: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """``Σ_k w[j, k] · vt[idx[j, k]]`` for each row j of (J, K) int32 ``idx``
    and float32 ``w``: (J, B) from vt (rows, B). One ``embedding_bag``: each
    row's K products are summed in order, with no gathered transient and no
    atomics, so two calls give the same bits."""
    return torch.nn.functional.embedding_bag(idx, vt, per_sample_weights=w, mode="sum")


def ell_phi_matvec_bm(mats: EllStepMatrices, modulator, v: torch.Tensor) -> torch.Tensor:
    """``V @ Φᵀ`` over ELL step matrices: (B, Nt) → (B, N). One pass over
    each step's rows; nothing of size (N, R, B) is materialized."""
    f = _f32(modulator, v.device)
    vt = v.T.contiguous()
    acc = torch.zeros((mats.num_nodes, v.shape[0]), dtype=torch.float32, device=v.device)
    for l in range(mats.max_walk_length):
        acc = acc + f[l] * _bag_sums(mats.cols[l], mats.vals[l], vt)
    return acc.T.contiguous()


def ell_phi_rmatvec_bm(mats: EllStepMatrices, modulator, v: torch.Tensor) -> torch.Tensor:
    """``V @ Φ`` by a scatter-add per step: (B, N) → (B, Nt). On CUDA the
    adds are float atomics in no fixed order; :func:`csc_phi_rmatvec_bm`
    computes the same product without a scatter."""
    f = _f32(modulator, v.device)
    b = v.shape[0]
    acc = torch.zeros((b, mats.num_target_nodes), dtype=torch.float32, device=v.device)
    for l in range(mats.max_walk_length):
        contrib = (f[l] * mats.vals[l])[None, :, :] * v[:, :, None]  # (B, N, R)
        acc = acc.index_add(1, mats.cols[l].reshape(-1), contrib.reshape(b, -1))
    return acc


def ell_phi_rows(mats: EllStepMatrices, modulator, rows: torch.Tensor) -> torch.Tensor:
    """Dense ``Φ[rows, :]`` (R, Nt). One index-add per step: within a step a
    row's columns are distinct (padded slots add 0 to column 0), so the
    result does not depend on the order of the adds."""
    dev = mats.cols.device
    f = _f32(modulator, dev)
    rows = torch.as_tensor(rows, device=dev).to(torch.int64)
    r, nt = rows.shape[0], mats.num_target_nodes
    row_ix = torch.arange(r, device=dev)[:, None] * nt
    out = torch.zeros(r * nt, dtype=torch.float32, device=dev)
    for l in range(mats.max_walk_length):
        flat = (row_ix + mats.cols[l, rows].to(torch.int64)).reshape(-1)
        out = out.index_add(0, flat, (f[l] * mats.vals[l, rows]).reshape(-1))
    return out.reshape(r, nt)


# ---------------------------------------------------------------------------
# The column-sorted transpose: Φᵀ products of unstructured graphs without a
# scatter. Each step's live entries are sorted by column and each column's
# run is padded to whole "virtual rows" of CSC_BLOCK entries, so a hub column
# costs its entry count, where a transposed ELL would pad every column to the
# largest one. The product gathers, sums each virtual row densely, then sums
# each column's virtual rows in order.
# ---------------------------------------------------------------------------

# The JAX package's virtual-row geometry (its 128-lane width) and chunking;
# they fix the layout of the ``.csc.npz`` sidecar both packages read.
CSC_BLOCK = 128
CSC_VROW_CHUNK = 1 << 15
# The stored fields of CscStepMatrices, as the sidecar names them.
CSC_FIELDS = ("rows", "vals", "seg_start", "last_pos", "has_any")


def column_vrow_pointers(last_pos: torch.Tensor, has_any: torch.Tensor) -> torch.Tensor:
    """(L, Nt + 1) int64: column c's virtual rows are ``ptr[l, c] ≤ j <
    ptr[l, c + 1]``. A column's rows follow the previous live column's, so
    ``ptr[l, c + 1]`` is one past the last row of the last live column ≤ c."""
    ends = torch.where(has_any, last_pos.to(torch.int64) + 1, 0)
    ends = torch.cummax(ends, dim=-1).values
    return torch.nn.functional.pad(ends, (1, 0))


@dataclasses.dataclass(frozen=True)
class CscStepMatrices:
    """Per-step transposed step matrices in virtual-row layout (the JAX
    package's fields, shapes and dtypes, as its ``.csc.npz`` sidecar holds them).

    rows: int32 (L, C, Vc, 128), source (start) node of each entry (pad 0).
    vals: float32 (L, C, Vc, 128), ``M_l[row, col]`` (pad entries 0).
    seg_start: bool (L, C, Vc), the virtual row opens a new column.
    last_pos: int32 (L, Nt), global index of column c's last virtual row
        (0 if none).
    has_any: bool (L, Nt), column c has a live entry.

    Derived on construction (and kept by :meth:`to`): ``vrow_ptr``, each
    column's range of virtual rows (:func:`column_vrow_pointers`), and
    ``used_vrows``, each step's count of virtual rows before the chunk
    padding (one read from the device).
    """

    rows: torch.Tensor
    vals: torch.Tensor
    seg_start: torch.Tensor
    last_pos: torch.Tensor
    has_any: torch.Tensor
    vrow_ptr: Optional[torch.Tensor] = None
    used_vrows: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.vrow_ptr is None:
            object.__setattr__(
                self, "vrow_ptr", column_vrow_pointers(self.last_pos, self.has_any)
            )
        if self.used_vrows is None:
            object.__setattr__(self, "used_vrows", tuple(self.vrow_ptr[:, -1].tolist()))

    @property
    def max_walk_length(self) -> int:
        return self.rows.shape[0]

    @property
    def num_target_nodes(self) -> int:
        return self.last_pos.shape[1]

    @property
    def vrow_chunk(self) -> int:
        return self.seg_start.shape[2]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.rows, self.vals, self.seg_start, self.last_pos, self.has_any, self.vrow_ptr))

    def to(self, device) -> "CscStepMatrices":
        return CscStepMatrices(
            *(t.to(device) for t in (
                self.rows, self.vals, self.seg_start, self.last_pos, self.has_any, self.vrow_ptr)),
            used_vrows=self.used_vrows,
        )


def segmented_sum_scan(z: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive within-segment prefix sum along the last axis: z (..., E),
    seg_start bool (E,) marking segment openers. Hillis–Steele shifted adds
    with flag propagation, as the JAX package's; log2(E) passes, and no sum
    crosses a segment. (:func:`csc_phi_rmatvec_bm` reduces each column with
    one segment sum instead.)"""
    e = z.shape[-1]
    s, flag = z, seg_start.clone()
    d = 1
    while d < e:
        shifted = torch.nn.functional.pad(s, (d, 0))[..., :e]
        f_sh = torch.nn.functional.pad(flag, (d, 0), value=True)[:e]
        s = torch.where(flag, s, s + shifted)
        flag = flag | f_sh
        d *= 2
    return s


def _ceil_mult(x: int, m: int) -> int:
    return -(-x // m) * m


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def transpose_ell(mats: EllStepMatrices) -> CscStepMatrices:
    """One-time build of the virtual-row column transpose, on the ELL's device
    (cache it with the step matrices: the preprocessor writes the
    ``.csc.npz`` sidecar). Per step: a stable sort of the live entries by
    column, each column's run padded to a multiple of CSC_BLOCK, the entries
    put into their (virtual row, lane) slots. Every array equals the JAX
    package's (integer work and copies only)."""
    l, n, r = mats.cols.shape
    nt = mats.num_target_nodes
    blk = CSC_BLOCK
    dev = mats.cols.device
    row_ix = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(r)
    per_step = []
    for li in range(l):
        v = mats.vals[li].reshape(-1)
        live = v != 0.0
        c_l, order = torch.sort(mats.cols[li].reshape(-1)[live], stable=True)
        v_l = v[live][order]
        r_l = row_ix[live][order]
        uniq, counts = torch.unique_consecutive(c_l, return_counts=True)
        padded = (counts + blk - 1) // blk * blk
        bases = _exclusive_cumsum(padded)
        dest = (
            torch.repeat_interleave(bases - _exclusive_cumsum(counts), counts)
            + torch.arange(c_l.numel(), device=dev)
        )
        total = max(int(padded.sum()), blk)
        rows_o = torch.zeros(total, dtype=torch.int32, device=dev)
        vals_o = torch.zeros(total, dtype=torch.float32, device=dev)
        rows_o[dest] = r_l
        vals_o[dest] = v_l
        seg = torch.zeros(total // blk, dtype=torch.bool, device=dev)
        seg[0] = True
        vbases = bases // blk
        seg[vbases] = True
        uniq = uniq.to(torch.int64)
        has = torch.zeros(nt, dtype=torch.bool, device=dev)
        has[uniq] = True
        last = torch.zeros(nt, dtype=torch.int32, device=dev)
        last[uniq] = (vbases + padded // blk - 1).to(torch.int32)
        per_step.append((rows_o, vals_o, seg, last, has))

    vmax = max(p[2].numel() for p in per_step)
    vc = min(CSC_VROW_CHUNK, 1 << (vmax - 1).bit_length() if vmax > 1 else 1)
    v_tot = _ceil_mult(vmax, vc)
    rows_all = torch.zeros((l, v_tot * blk), dtype=torch.int32, device=dev)
    vals_all = torch.zeros((l, v_tot * blk), dtype=torch.float32, device=dev)
    seg_all = torch.zeros((l, v_tot), dtype=torch.bool, device=dev)
    for li, (rows_o, vals_o, seg, _, _) in enumerate(per_step):
        rows_all[li, : rows_o.numel()] = rows_o
        vals_all[li, : vals_o.numel()] = vals_o
        seg_all[li, : seg.numel()] = seg
    shape = (l, v_tot // vc, vc)
    return CscStepMatrices(
        rows=rows_all.reshape(*shape, blk),
        vals=vals_all.reshape(*shape, blk),
        seg_start=seg_all.reshape(shape),
        last_pos=torch.stack([p[3] for p in per_step]),
        has_any=torch.stack([p[4] for p in per_step]),
    )


def csc_phi_rmatvec_bm(csc: CscStepMatrices, modulator, v: torch.Tensor) -> torch.Tensor:
    """``V @ Φ`` through the column-sorted transpose: (B, Nsrc) → (B, Nt).

    Per step, over the used virtual rows: each virtual row's 128 products
    summed in order (:func:`_bag_sums`), then each column's virtual rows
    summed in order by one segment sum. No scatter and no atomics: two calls
    on the same input give the same bits.
    """
    f = _f32(modulator, v.device)
    vt = v.T.contiguous()
    blk = CSC_BLOCK
    acc = torch.zeros((csc.num_target_nodes, v.shape[0]), dtype=torch.float32, device=v.device)
    for l in range(csc.max_walk_length):
        used = csc.used_vrows[l]
        rows_l = csc.rows[l].reshape(-1, blk)[:used]
        vals_l = csc.vals[l].reshape(-1, blk)[:used]
        partial = _bag_sums(rows_l, vals_l, vt)  # (V, B)
        acc = acc + f[l] * torch.segment_reduce(partial, "sum", offsets=csc.vrow_ptr[l], axis=0)
    return acc.T.contiguous()


def csc_phi_rmatvec(csc: CscStepMatrices, modulator, v: torch.Tensor) -> torch.Tensor:
    """``Φᵀ @ v`` through the transpose; v (Nsrc,) → (Nt,)."""
    return csc_phi_rmatvec_bm(csc, modulator, v[None, :])[0]


# ---------------------------------------------------------------------------
# Analytic transposes. The products are linear in (f, v); each declares its
# adjoint as the opposite-direction product in its best layout:
#
#     d/dv [V Φᵀ] · G = G Φ      (the transposed product: CSC, no scatter)
#     d/dv [V Φ]  · G = G Φᵀ     (the forward product: ELL gathers)
#     d/df_l          = ⟨A, B M_lᵀ⟩ per step (one gather and a dot)
#
# The step matrices are fixed Monte-Carlo samples: gradients go to the
# modulator and the vector only, and asking for one through the step-matrix
# values raises.
# ---------------------------------------------------------------------------


def _ell_df(mats: EllStepMatrices, a: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """``df_l = Σ_{b,i} a[b, i] · (bb M_lᵀ)[b, i]``, the modulator cotangent
    of both products."""
    bt = bb.T.contiguous()
    at = a.T
    return torch.stack([
        (at * _bag_sums(mats.cols[l], mats.vals[l], bt)).sum()
        for l in range(mats.max_walk_length)
    ])


def _rmatvec_bm(mats: EllStepMatrices, csc: Optional[CscStepMatrices], f, v):
    if csc is not None:
        return csc_phi_rmatvec_bm(csc, f, v)
    return ell_phi_rmatvec_bm(mats, f, v)


def _assert_unperturbed(mats: EllStepMatrices, csc: Optional[CscStepMatrices]) -> None:
    """Fail loudly if a caller differentiates through step-matrix values:
    the products' backward rules give gradients to (modulator, vector)
    only, so such a caller would silently get none."""
    if not torch.is_grad_enabled():
        return
    if mats.vals.requires_grad or (csc is not None and csc.vals.requires_grad):
        raise ValueError(
            "differentiating through ELL/CSC step-matrix values is unsupported: the "
            "ELL/CSC products declare analytic transposes only for (modulator, vector); "
            "detach the step matrices or differentiate the dense layout instead"
        )


class _EllMatvecBm(torch.autograd.Function):
    """``V Φᵀ`` (B, Nt) → (B, N) with its analytic transpose."""

    @staticmethod
    def forward(ctx, f, v, mats, csc):
        ctx.mats, ctx.csc = mats, csc
        ctx.save_for_backward(f, v)
        return ell_phi_matvec_bm(mats, f, v)

    @staticmethod
    def backward(ctx, g):
        f, v = ctx.saved_tensors
        df = _ell_df(ctx.mats, g, v) if ctx.needs_input_grad[0] else None
        dv = _rmatvec_bm(ctx.mats, ctx.csc, f, g) if ctx.needs_input_grad[1] else None
        return df, dv, None, None


class _EllRmatvecBm(torch.autograd.Function):
    """``V Φ`` (B, N) → (B, Nt) with its analytic transpose."""

    @staticmethod
    def forward(ctx, f, v, mats, csc):
        ctx.mats, ctx.csc = mats, csc
        ctx.save_for_backward(f, v)
        return _rmatvec_bm(mats, csc, f, v)

    @staticmethod
    def backward(ctx, g):
        f, v = ctx.saved_tensors
        df = _ell_df(ctx.mats, v, g) if ctx.needs_input_grad[0] else None
        dv = ell_phi_matvec_bm(ctx.mats, f, g) if ctx.needs_input_grad[1] else None
        return df, dv, None, None


@dataclasses.dataclass(frozen=True)
class EllFeatures:
    """Φ over consolidated ELL step matrices: the large-N layout of
    unstructured graphs.

    With ``csc`` (the column-sorted transpose, :func:`with_transpose`)
    attached, the transposed products gather and never scatter; without it
    they scatter-add, as the JAX package's do.
    """

    mats: EllStepMatrices
    csc: Optional[CscStepMatrices] = None

    @property
    def num_nodes(self) -> int:
        return self.mats.num_nodes

    @property
    def num_target_nodes(self) -> int:
        return self.mats.num_target_nodes

    @property
    def max_walk_length(self) -> int:
        return self.mats.max_walk_length

    def _f(self, f) -> torch.Tensor:
        return _f32(f, self.mats.cols.device)

    def matvec_bm(self, f, v):
        _assert_unperturbed(self.mats, self.csc)
        return _EllMatvecBm.apply(self._f(f), v, self.mats, self.csc)

    def rmatvec_bm(self, f, v):
        _assert_unperturbed(self.mats, self.csc)
        return _EllRmatvecBm.apply(self._f(f), v, self.mats, self.csc)

    def matvec(self, f, v):
        """``Φ @ v``; v (Nt,) or column-major (Nt, B)."""
        if v.dim() == 1:
            return self.matvec_bm(f, v[None, :])[0]
        return self.matvec_bm(f, v.T).T

    def rmatvec(self, f, v):
        """``Φᵀ @ v``; v (N,) or column-major (N, B)."""
        if v.dim() == 1:
            return self.rmatvec_bm(f, v[None, :])[0]
        return self.rmatvec_bm(f, v.T).T

    def rows(self, f, idx):
        return ell_phi_rows(self.mats, self._f(f), idx)

    def to(self, device) -> "EllFeatures":
        return EllFeatures(self.mats.to(device), None if self.csc is None else self.csc.to(device))


def with_transpose(feats: EllFeatures) -> EllFeatures:
    """Attach the column-sorted transpose (one sort per step; cacheable)."""
    if feats.csc is not None:
        return feats
    return EllFeatures(feats.mats, transpose_ell(feats.mats))


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
    with profiling.span("prep.vocabulary"):
        offsets = offset_vocabulary(mats, max_offsets, chunk_rows)
    if offsets is None:
        return None
    with profiling.span("prep.stencil_build"):
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

    def matvec(self, f, v):
        return stencil_phi_matvec(self.mats, f, v)

    def rmatvec(self, f, v):
        return stencil_phi_rmatvec(self.mats, f, v)

    def matvec_bm(self, f, v):
        return stencil_phi_matvec_bm(self.mats, f, v)

    def rmatvec_bm(self, f, v):
        return stencil_phi_rmatvec_bm(self.mats, f, v)

    def rows(self, f, idx):
        return stencil_phi_rows(self.mats, f, idx)

    def to(self, device) -> "StencilFeatures":
        return StencilFeatures(
            StencilStepMatrices(self.mats.vals.to(device), self.mats.offsets)
        )


# The uncontracted stencil products fold the modulator in at every call (a
# solver loop should :func:`contract` once instead); on the card each product
# is kernel K1.


def stencil_phi_matvec_bm(mats: StencilStepMatrices, modulator, v: torch.Tensor) -> torch.Tensor:
    """``V @ Φᵀ``: Σ_s w_s ⊙ roll(v, −off_s). v: (B, N) → (B, N)."""
    return contract(StencilFeatures(mats), modulator).matvec_bm(v)


def stencil_phi_rmatvec_bm(mats: StencilStepMatrices, modulator, v: torch.Tensor) -> torch.Tensor:
    """``V @ Φ``: Σ_s roll(w_s ⊙ v, +off_s). v: (B, N) → (B, N)."""
    return contract(StencilFeatures(mats), modulator).rmatvec_bm(v)


def stencil_phi_matvec(mats: StencilStepMatrices, modulator, v: torch.Tensor) -> torch.Tensor:
    """``Φ @ v``; v (N,) or column-major (N, B)."""
    return stencil_phi_matvec_bm(mats, modulator, _as_rows(v)).T.reshape(v.shape)


def stencil_phi_rmatvec(mats: StencilStepMatrices, modulator, v: torch.Tensor) -> torch.Tensor:
    """``Φᵀ @ v``; v (N,) or column-major (N, B)."""
    return stencil_phi_rmatvec_bm(mats, modulator, _as_rows(v)).T.reshape(v.shape)


def stencil_phi_rows(mats: StencilStepMatrices, modulator, rows: torch.Tensor) -> torch.Tensor:
    """Dense ``Φ[rows, :]`` (R, N): a small scatter of R·S entries."""
    return contract(StencilFeatures(mats), modulator).rows(torch.as_tensor(rows))


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


@dataclasses.dataclass(frozen=True)
class ContractedFeatures:
    """The modulator bound to a layout whose products cannot pre-fold it
    (ELL, dense): the same surface as :class:`ContractedStencil`, so solver
    carries do not depend on the layout. ``f`` is a direct tensor field, so
    the solvers' adjoints (which flatten a carry one level deep) give it its
    gradient; the step matrices inside ``feats`` stay fixed."""

    feats: object
    f: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.feats.num_nodes

    @property
    def num_target_nodes(self) -> int:
        return self.feats.num_target_nodes

    def matvec_bm(self, v):
        return self.feats.matvec_bm(self.f, v)

    def rmatvec_bm(self, v):
        return self.feats.rmatvec_bm(self.f, v)

    def rows(self, idx):
        return self.feats.rows(self.f, idx)


def contract(feats, f: torch.Tensor):
    """Fold the modulator into the feature operator, once per solve:
    StencilFeatures → ContractedStencil (w precomputed; products by K1);
    EllFeatures, LogFeatures and DenseFeatures, whole or split over ranks
    (``shard.ShardedFeatures``) → ContractedFeatures (a binding)."""
    from .shard import ShardedFeatures

    if isinstance(feats, StencilFeatures):
        vals = feats.mats.vals
        w = torch.einsum("l,lsn->sn", _f32(f, vals.device), vals)
        offsets = feats.mats.offsets
        w_shift = k_stencil.shifted_weights(w, k_stencil.center_offsets(offsets, w.shape[1]))
        return ContractedStencil(w=w, w_shift=w_shift, offsets=offsets)
    if isinstance(feats, EllFeatures):
        return ContractedFeatures(feats, _f32(f, feats.mats.cols.device))
    if isinstance(feats, LogFeatures):
        return ContractedFeatures(feats, _f32(f, feats.log.curs.device))
    if isinstance(feats, DenseFeatures):
        return ContractedFeatures(feats, _f32(f, feats.step_matrices.device))
    if isinstance(feats, ShardedFeatures):
        return ContractedFeatures(feats, _f32(f, feats.mesh.device))
    raise TypeError(f"contract(): no feature layout {type(feats).__name__}")


def step_rows(feats, idx: torch.Tensor) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The entries of every step matrix in rows ``idx``, as (cols, vals):
    vals (L, R, K) float32 and int64 column ids in the target space, (L, R,
    K) on ELL and (1, R, K) on a stencil, whose columns are the same at
    every step. None for the other layouts.

    Within one step a row's nonzero entries have distinct columns: ELL
    padding is column 0 with value 0, and in a stencil built by
    :func:`ell_to_stencil` offsets that alias mod N carry weight 0 in all
    but one of them. Stencil columns wrap mod N, as K1's products do."""
    if isinstance(feats, StencilFeatures):
        vals = feats.mats.vals
        idx = idx.to(device=vals.device, dtype=torch.int64)
        offs = torch.as_tensor(feats.mats.offsets, dtype=torch.int64, device=vals.device)
        cols = torch.remainder(idx[:, None] + offs[None, :], feats.num_nodes)
        return cols[None], vals[:, :, idx].transpose(1, 2)
    if isinstance(feats, EllFeatures):
        idx = idx.to(device=feats.mats.cols.device, dtype=torch.int64)
        return feats.mats.cols[:, idx].to(torch.int64), feats.mats.vals[:, idx]
    return None


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
