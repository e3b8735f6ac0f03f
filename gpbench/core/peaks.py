"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM and the
work a product needs, counted from its shapes.

Peaks are NVIDIA's data-sheet figures at the 700 W limit: HBM3 at 3.35 TB/s
and 67 TFLOP/s in float32 outside the tensor cores. A card set to a lower
power limit reads lower shares; the harness prints the limit beside them.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_seconds(nbytes: float, flops: float) -> float:
    """The least time for the work: bytes at the HBM rate or float32
    operations at the FP32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def stencil_work(offsets: int, batch: int, nodes: int) -> tuple:
    """(bytes, flops) of one stencil product or weight gradient,
    ``out[b, i] = Σ_s w[s, i] · v[b, i + off_s]``: the (S, N) weights and the
    (B, N) input read once, the (B, N) output written once; a multiply-add
    per weight and row."""
    return 4.0 * (offsets * nodes + 2 * batch * nodes), 2.0 * offsets * batch * nodes


def sparse_work(live: int, batch: int, rows: int, cols: int) -> tuple:
    """(bytes, flops) of one product of B vectors with a sparse matrix of
    ``live`` stored entries: each live entry's value and index once, the
    (B, cols) input read once and the (B, rows) output written once (the
    padding of a fixed-width layout is not work the product needs)."""
    return 8.0 * live + 4.0 * batch * (rows + cols), 2.0 * live * batch


def share_percent(nbytes: float, flops: float, seconds: float):
    """The work's least time as a percentage of the device seconds it took;
    None where no device time was read."""
    if seconds <= 0:
        return None
    return 100.0 * bound_seconds(nbytes, flops) / seconds
