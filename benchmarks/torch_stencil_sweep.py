#!/usr/bin/env python3
"""Batch-size sweep of the port's stencil kernels on one CUDA card.

Times K1 (stencil product), its dw kernel (the weight gradient), K2a and K2b
(the fused masked-Gram passes, mask = every second node) of
graphgp_tpu_torch on random tensors, for B in 1, 4, 8, 12, 16, at the
flagship grid's shape (S = 41 offsets dx + 1000·dy with |dx| + |dy| ≤ 4,
N = 1e6) in two orders of the same offsets, sorted ascending (what the
offset vocabulary gives) and dx-major (neighbouring offsets far apart in
memory; every kernel's band planner sorts them, so the order should not
matter), and at a ring's shape (S = 9 offsets −4..4, N = 2^20, the scaling
path's size). CUDA events, 50 launches after 5 warm-ups; two rounds, to
show the spread.

Usage, from the repository root: python3 benchmarks/torch_stencil_sweep.py
"""
import subprocess
import sys

import torch

sys.path.insert(0, ".")
from graphgp_tpu_torch.cuda_kernels import gram as k2  # noqa: E402
from graphgp_tpu_torch.cuda_kernels import stencil as k1  # noqa: E402

GRID_N, RING_N = 1_000_000, 2**20


def ms(fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stencil_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = "cuda"
    dx_major = tuple(dx + 1000 * dy for dx in range(-4, 5) for dy in range(-4, 5)
                     if abs(dx) + abs(dy) <= 4)
    assert len(dx_major) == 41
    shapes = (("grid sorted", GRID_N, tuple(sorted(dx_major))), ("grid dx-major", GRID_N, dx_major),
              ("ring", RING_N, tuple(range(-4, 5))))
    for name, n, offs in shapes:
        w = torch.randn(len(offs), n, device=dev)
        w_shift = torch.randn(len(offs), n, device=dev)
        mask = torch.zeros(n, device=dev)
        mask[::2] = 1
        nv = torch.tensor([0.1], device=dev)
        neg = tuple(-o for o in offs)
        for rnd in range(2):
            for b in (1, 4, 8, 12, 16):
                v = torch.randn(b, n, device=dev)
                t = torch.randn(b, n, device=dev)
                print(f"{name} round {rnd} B={b}: "
                      f"K1 {ms(lambda: k1.stencil_matvec_cuda(w, v, offs)):.4f} ms  "
                      f"dw {ms(lambda: k1.stencil_dw_cuda(v, t, offs)):.4f} ms  "
                      f"K2a {ms(lambda: k2.rmv_mask_cuda(w_shift, mask, v, neg)):.4f} ms  "
                      f"K2b {ms(lambda: k2.mv_epilogue_cuda(w, t, mask, v, nv, offs)):.4f} ms",
                      flush=True)
        del w, w_shift
    return 0


if __name__ == "__main__":
    sys.exit(main())
