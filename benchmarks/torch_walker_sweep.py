#!/usr/bin/env python3
"""Kernel K4 (fused walks -> dense step matrices) alone, over shapes.

For each shape: the kernels' own device time from torch.profiler (the mean
duration of each kernel a launch runs, the table pack and the walks, over
REPS launches, summed), the wrapper's time from CUDA events around REPS
back-to-back calls (at small shapes that is the host's launch path, not the
kernel), the plain PyTorch version's time, and the kernel's largest difference from the
plain version relative to max |ref|. Shapes: the ablation protocol's mesh
(both load updates), the PEMS sensor graph at 1 / 16 / 1024 walks per node,
and a 64 x 64 grid at 64 and 8192 walks per node and at L = 16.

Usage: python3 benchmarks/torch_walker_sweep.py   (needs a CUDA card; run from the repo's root)
"""
from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 10


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_walker_sweep: no CUDA device", file=sys.stderr)
        return 2
    from graphgp_tpu_torch.cuda_kernels import walker as k4
    from graphgp_tpu_torch.data import database, synthetic
    from graphgp_tpu_torch.graphs import pack_dense, pack_laplacian
    from graphgp_tpu_torch.walker import WalkConfig

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    mesh = synthetic._grid_adjacency(30).toarray()
    pems = database._load_csr_npz("processed_data/pems_bay.npz")[0]
    big = synthetic.generate("grid", 4096, seed=0)["adjacency"]
    cases = [
        ("mesh 30x30, principled", pack_laplacian(mesh), WalkConfig(1000, 0.01, 10)),
        ("mesh 30x30, ad-hoc", pack_dense(mesh), WalkConfig(1000, 0.01, 10, ablation=True)),
        ("PEMS", pack_laplacian(pems), WalkConfig(1, 0.1, 10)),
        ("PEMS", pack_laplacian(pems), WalkConfig(16, 0.1, 10)),
        ("PEMS", pack_laplacian(pems), WalkConfig(1024, 0.1, 10)),
        ("grid 64x64", pack_laplacian(big), WalkConfig(64, 0.1, 10)),
        ("grid 64x64", pack_laplacian(big), WalkConfig(8192, 0.1, 10)),
        ("grid 64x64", pack_laplacian(big), WalkConfig(256, 0.1, 16)),
    ]
    for name, graph, cfg in cases:
        graph = graph.to("cuda")
        run = lambda: k4.sample_dense_step_matrices_cuda(graph, 1, cfg)
        out = run()
        ref = k4.sample_dense_step_matrices_plain(graph, 1, cfg)
        rel = float((out - ref).abs().max() / ref.abs().max())
        del out, ref
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                run()
            torch.cuda.synchronize()
        kernel_us = {}
        for e in prof.events():
            for kname in ("walk_step_matrices", "pack_walk_table"):
                if e.device_type == DeviceType.CUDA and kname in e.name:
                    kernel_us.setdefault(kname, []).append(e.time_range.elapsed_us())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            run()
        end.record()
        torch.cuda.synchronize()
        wrapper_ms = start.elapsed_time(end) / REPS
        start.record()
        k4.sample_dense_step_matrices_plain(graph, 1, cfg)
        end.record()
        torch.cuda.synchronize()
        kernel = (f"{sum(sum(v) / len(v) for v in kernel_us.values()) / 1e3:.4f}"
                  if kernel_us else "not measured")
        print(f"{name}: N={graph.num_nodes} D={graph.max_degree} W={cfg.walks_per_node} "
              f"L={cfg.max_walk_length} p_halt={cfg.p_halt}: kernel {kernel} ms "
              f"({sum(map(len, kernel_us.values()))} kernels profiled in {REPS} launches), wrapper {wrapper_ms:.4f} ms, plain "
              f"{start.elapsed_time(end):.4f} ms, rel err {rel:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
