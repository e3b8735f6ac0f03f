"""K3, the ELL → stencil conversion, and its plain PyTorch version.

``out[l, s, i] = Σ_r vals[l, i, r] · [vals ≠ 0 ∧ cols[l, i, r] − i = off_s]``
maps (L, N, R) ELL step matrices onto (L, S, N) stencil values for a sorted
offset vocabulary. Counterpart of
``graphgp_tpu/pallas_kernels/stencil_build.py``; the CUDA kernel is
``csrc/stencil_build.cu``.

A consolidated row holds distinct live columns, so each output cell receives
at most one entry: the kernel's result is bit-identical to the plain version
(the compare-and-reduce of the JAX package's ``features._stencil_chunk``).
CUDA tensors launch the kernel (or raise); CPU tensors take the plain version.

:func:`plan` picks the kernel's schedule. The staged one: ``tile`` nodes
of one step per tile, whose ``tile · R`` entries are staged in chunks of
``chunk`` entries, one chunk at a time, by TMA bulk copies when every chunk
starts and ends on 16 bytes (``bulk``) and by 4-byte ``cp.async`` copies
otherwise. Rows of at most ``NARROW_ROW_SLOTS`` slots whose offsets span
too many columns for a direct slot table take the narrow-row one instead: a
thread a node, reading its own slots.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build

MAX_OFFSETS = 256
THREADS = 256  # csrc/stencil_build.cu: kThreads
NODE_THREADS = 128  # csrc/stencil_build.cu: kNodeThreads, the narrow-row schedule's block
NARROW_ROW_SLOTS = 8  # the narrow-row schedule: at most this many slots, no direct table
MIN_TILE, MAX_TILE = 32, 512
STAGE_ENTRIES = 4096  # a stage's cols and vals: 32 KB
TILE_BYTES = 65536  # the (S, tile) accumulator, at most
MAX_LOOKUP_ENTRIES = 16384  # a direct slot table for offsets spanning up to this many columns
MAX_DYNAMIC_SMEM_BYTES = 232448  # 227 KB, the most a block may ask for on sm_90

# Kernel launches since the last reset; chip_smoke.py reads it.
launches = 0


class Plan(NamedTuple):
    """K3's schedule for one (N, R, S): see the module's docstring. The
    narrow-row schedule (``staged`` false) reads no other field."""

    staged: bool
    tile: int
    chunk: int
    bulk: bool
    lookup: int

    def chunks(self, r: int) -> int:
        """Chunks of one tile's slab of ``tile · r`` entries."""
        return -(-self.tile * r // self.chunk)

    def smem_bytes(self, s: int) -> int:
        """Dynamic shared memory of a block. Staged: the mbarrier, the cols
        and vals buffer, the (S, tile + 1) tile, the offsets and the direct
        slot table; narrow rows: the offsets and an (S, 128) tile."""
        if not self.staged:
            return 4 * s * (NODE_THREADS + 1)
        return 32 + 8 * self.chunk + 4 * s * (self.tile + 1) + 4 * s + 2 * self.lookup


def plan(n: int, r: int, s: int, span: int, aligned: bool = True) -> Plan:
    """Narrow rows (R ≤ NARROW_ROW_SLOTS) whose offsets span more than
    MAX_LOOKUP_ENTRIES columns, so that the staged schedule would search:
    one thread a node. Else :func:`staged_plan`."""
    if r <= NARROW_ROW_SLOTS and span > MAX_LOOKUP_ENTRIES:
        return Plan(False, NODE_THREADS, 0, False, 0)
    return staged_plan(n, r, s, span, aligned)


def staged_plan(n: int, r: int, s: int, span: int, aligned: bool = True) -> Plan:
    """The widest power-of-two tile in [32, 512] whose slab fits one stage
    (4096 entries) and whose accumulator fits 64 KB, 32 when none does; one
    chunk per tile when the slab fits a stage, else chunks of 4096 entries.
    Bulk copies when ``aligned`` (cols and vals start on 16 bytes) and N · R
    is a multiple of 4: then every chunk starts and ends on 16 bytes. A
    direct slot table of ``span`` entries when the offsets span (last −
    first + 1 columns) is at most MAX_LOOKUP_ENTRIES, else a binary search."""
    tile = MAX_TILE
    while tile > MIN_TILE and (tile * r > STAGE_ENTRIES or 4 * s * tile > TILE_BYTES):
        tile //= 2
    chunk = min(tile * r, STAGE_ENTRIES)
    bulk = bool(aligned and (n * r) % 4 == 0 and chunk % 4 == 0)
    return Plan(True, tile, chunk, bulk, span if span <= MAX_LOOKUP_ENTRIES else 0)


def offsets_span(offsets: torch.Tensor) -> int:
    """Columns from the first offset to the last, both included, 0 for no
    offsets (read from the device when the offsets lie there)."""
    if offsets.numel() == 0:
        return 0
    first, last = offsets[[0, -1]].tolist()
    return last - first + 1


def ell_to_stencil_plain(
    cols: torch.Tensor, vals: torch.Tensor, offsets: torch.Tensor,
    chunk_bytes: int = 256 << 20,
) -> torch.Tensor:
    """Slot lookup by ``searchsorted`` and a one-hot reduction over R, chunked
    over nodes so the (L, C, R, S) one-hot stays within ``chunk_bytes``."""
    l, n, r = cols.shape
    offs = offsets.to(device=cols.device, dtype=torch.int64)
    s = offs.numel()
    c_max = max(chunk_bytes // (l * r * s * 4), 256)
    slot_ids = torch.arange(s, device=cols.device)
    slabs = []
    for lo in range(0, n, c_max):
        hi = min(lo + c_max, n)
        rows = torch.arange(lo, hi, device=cols.device)[None, :, None]
        diffs = cols[:, lo:hi].to(torch.int64) - rows
        slot = torch.clamp(torch.searchsorted(offs, diffs), max=s - 1)
        v = vals[:, lo:hi]
        live = (v != 0) & (offs[slot] == diffs)
        v = torch.where(live, v, 0.0)
        onehot = (slot[..., None] == slot_ids).to(torch.float32)
        slabs.append(torch.einsum("lcr,lcrs->lsc", v, onehot))
    return slabs[0] if len(slabs) == 1 else torch.cat(slabs, dim=2)


def ell_to_stencil_cuda(cols: torch.Tensor, vals: torch.Tensor, offsets: torch.Tensor,
                        schedule: Optional[Plan] = None) -> torch.Tensor:
    """Launch K3 once: cols int32 / vals float32 (L, N, R) and sorted int32
    offsets (S ≤ 256), contiguous on one CUDA device → float32 (L, S, N).
    ``schedule`` replaces :func:`plan`'s (the kernel checks it; without it
    the offsets' span is read back from the device)."""
    global launches
    if not (cols.is_cuda and vals.is_cuda and offsets.is_cuda):
        raise ValueError("ell_to_stencil_cuda: all inputs must be CUDA tensors")
    if not (cols.device == vals.device == offsets.device):
        raise ValueError("ell_to_stencil_cuda: inputs on different devices")
    if cols.dtype != torch.int32 or vals.dtype != torch.float32 or offsets.dtype != torch.int32:
        raise ValueError("ell_to_stencil_cuda: want int32 cols, float32 vals, int32 offsets")
    if not (cols.is_contiguous() and vals.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("ell_to_stencil_cuda: inputs must be contiguous")
    if cols.dim() != 3 or cols.shape != vals.shape or offsets.dim() != 1:
        raise ValueError(f"ell_to_stencil_cuda: bad shapes {tuple(cols.shape)} {tuple(vals.shape)}")
    l, n, r = cols.shape
    s = offsets.numel()
    if not 1 <= s <= MAX_OFFSETS or not 1 <= l <= 65535 or r < 1:
        raise ValueError(f"ell_to_stencil_cuda: S={s}, L={l}, R={r} out of range")
    if schedule is None:
        schedule = plan(n, r, s, offsets_span(offsets), aligned=_aligned(cols, vals))
    lib = _build.load()
    out = torch.empty((l, s, n), dtype=torch.float32, device=cols.device)
    with _build.on_device(cols.device):
        rc = lib.ell_to_stencil_f32(
            cols.data_ptr(), vals.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            l, n, r, s, int(schedule.staged), schedule.tile, schedule.chunk, int(schedule.bulk),
            schedule.lookup, _build.stream(cols.device),
        )
    launches += 1
    _build.check(rc, "ell_to_stencil_f32")
    return out


def _aligned(cols: torch.Tensor, vals: torch.Tensor) -> bool:
    return cols.data_ptr() % 16 == 0 and vals.data_ptr() % 16 == 0


def ell_to_stencil(cols: torch.Tensor, vals: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(L, N, R) ELL + sorted offset vocabulary → (L, S, N) stencil values:
    the kernel for CUDA tensors, the plain version for CPU tensors. Offsets
    given on the host are planned from there, with no read from the device."""
    if not cols.is_cuda:
        return ell_to_stencil_plain(cols, vals, offsets)
    cols, vals = cols.contiguous(), vals.contiguous()
    l, n, r = cols.shape
    schedule = plan(n, r, offsets.numel(), offsets_span(offsets), aligned=_aligned(cols, vals))
    return ell_to_stencil_cuda(
        cols, vals, offsets.to(device=cols.device, dtype=torch.int32).contiguous(), schedule,
    )
