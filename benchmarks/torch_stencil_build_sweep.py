#!/usr/bin/env python3
"""Kernel K3 (ELL -> stencil) alone, through the package's public wrapper.

For the flagship's ELL (1000x1000 grid, walks_per_node 1000, p_halt 0.1,
L 5) and the scaling path's largest ring (N = 2^20, walks_per_node 100,
L 3): the kernel's own device time from torch.profiler (the mean of REPS
launches), the wrapper's time from CUDA events around REPS back-to-back calls
of ``stencil_build.ell_to_stencil`` (offsets given on the host, as
``features.ell_to_stencil`` gives them), the share of the byte bound, and
whether the result equals the plain version bit for bit. It uses only the
wrapper, so the same file times another checkout of the package when copied
into that checkout's ``benchmarks/``.

Usage: python3 benchmarks/torch_stencil_build_sweep.py   (needs a CUDA card; run from the repo's root)
"""
from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 10
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_stencil_build_sweep: no CUDA device", file=sys.stderr)
        return 2
    from graphgp_tpu_torch.cuda_kernels import stencil_build as k3
    from graphgp_tpu_torch.data import synthetic
    from graphgp_tpu_torch.preprocessor import preprocess_graph
    from graphgp_tpu_torch.walker import WalkConfig

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"package: {os.path.dirname(k3.__file__)}", flush=True)
    for kind, n, cfg in (("grid", 1_000_000, WalkConfig(1000, 0.1, 5)),
                         ("ring", 2**20, WalkConfig(100, 0.1, 3))):
        trace: dict = {}
        feats = preprocess_graph(synthetic.generate(kind, n, seed=42)["adjacency"], cfg, seed=42,
                                 cache_dir=None, layout="auto", device="cuda", trace=trace)
        cols, vals = trace["ell"].cols, trace["ell"].vals
        offs = torch.from_numpy(feats.mats.offsets)
        run = lambda: k3.ell_to_stencil(cols, vals, offs)
        out = run()
        equal = torch.equal(out, k3.ell_to_stencil_plain(cols, vals, offs.to("cuda")))
        del out
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                run()
            torch.cuda.synchronize()
        kernel_us = [e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA and "ell_to_stencil" in e.name]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            run()
        end.record()
        torch.cuda.synchronize()
        wrapper_ms = start.elapsed_time(end) / REPS
        l, _, r = cols.shape
        s = offs.numel()
        bound = (8.0 * l * n * r + 4.0 * l * s * n) / HBM_BYTES_PER_S * 1e3
        kernel = sum(kernel_us) / len(kernel_us) / 1e3 if kernel_us else float("nan")
        print(f"{kind} N={n} L={l} R={r} S={s}: kernel {kernel:.4f} ms ({len(kernel_us)} kernels "
              f"profiled in {REPS} launches), wrapper {wrapper_ms:.4f} ms, byte bound "
              f"{bound:.4f} ms ({bound / kernel:.2f} of it), equal to the plain version: {equal}",
              flush=True)
        del feats, trace, cols, vals
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
