#!/usr/bin/env python3
"""Wall and device time of one flagship fit epoch, for two trees side by side.

Builds the flagship's stencil (1000x1000 grid, walks_per_node 1000, p_halt
0.1, L 5, data and walk seed 42) and fits the GP as the BO flagship does
(modulator "free", Adam lr 0.1, cg_tol 1e-2, at most 100 CG iterations) at
1010 observed nodes drawn with seed 100, the flagship's last observation
count. After one warm epoch it reports the wall ms per epoch of REPEATS fits
of EPOCHS epochs each, then the device ms per epoch by op group from
torch.profiler over one more fit, as one JSON line.

``--root DIR`` imports graphgp_tpu_torch from DIR (default: this tree), so
the same script measures an older checkout unpacked beside it; run the trees
in turns (A, B, B, A) in one call.

Usage: python3 benchmarks/torch_fit_epoch.py [--root DIR] [--label NAME]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

EPOCHS = 10
REPEATS = 3
PROFILE_EPOCHS = 3
GROUPS = (("K1", "stencil_matvec_kernel"), ("K1 dw", "stencil_dw_kernel"), ("roll", "roll"),
          ("elementwise", "elementwise"), ("reductions", "reduce"))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=".")
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fit_epoch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from graphgp_tpu_torch.data import synthetic
    from graphgp_tpu_torch.gp import iterative
    from graphgp_tpu_torch.preprocessor import preprocess_graph
    from graphgp_tpu_torch.walker import WalkConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    n = 1000 * 1000
    data = synthetic.generate("grid", n, seed=42)
    feats = preprocess_graph(data["adjacency"], WalkConfig(1000, 0.1, 5), seed=42,
                             cache_dir=None, layout="auto", device=dev)
    idx = np.random.default_rng(100).choice(n, 1010, replace=False)
    train_idx = torch.from_numpy(idx).to(dev)
    y = torch.from_numpy(data["y_observed"][idx].astype(np.float32)).to(dev)
    mask = torch.ones(idx.size, device=dev)
    settings = iterative.CGSettings(cg_tol=1e-2, cg_max_iters=100)

    def fit(steps):
        gen = torch.Generator(device=dev).manual_seed(0)
        iterative.fit(feats, train_idx, y, kind="free", learning_rate=0.1, num_steps=steps,
                      settings=settings, mask=mask, num_real=float(idx.size), generator=gen)
        torch.cuda.synchronize()

    fit(1)  # warm: the kernels' build and first launches
    wall = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fit(EPOCHS)
        wall.append((time.perf_counter() - t0) * 1e3 / EPOCHS)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        fit(PROFILE_EPOCHS)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by = {name: 0.0 for name, _ in GROUPS}
    by["other"] = 0.0
    for e in events:
        group = next((name for name, key in GROUPS if key in e.name), "other")
        by[group] += e.time_range.elapsed_us() / 1e3 / PROFILE_EPOCHS
    print(json.dumps({"label": args.label, "card": card, "wall_ms_per_epoch": wall,
                      "device_ms_per_epoch": sum(by.values()), "by_op": by}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
