#!/usr/bin/env python3
"""``cli.hmc.main`` at its defaults several times on the card: split R-hat
and accept rates a run.

Every run draws the same generator seed (0, as the CLI does), but its step
matrices come from the fused walk kernel, whose float atomics sum in no
fixed order; HMC is chaotic, so each run is a fresh realization of the
chains. The share of runs with a split R-hat at or above 1.1 is the
sampler's failure rate at the flags given (4 chains, 300 samples; the
CLI's step jitter 0.1 unless ``--step-jitter`` is passed on, 0 being the
JAX package's fixed step).

Usage: python3 benchmarks/torch_hmc_mixing.py RUNS [CLI FLAGS ...]
    (needs a CUDA card; run from the repo's root)
"""
import sys
import tempfile
import time

sys.path.insert(0, ".")
import chip_smoke as cs
from graphgp_tpu_torch.cli import hmc as hmc_cli

cs.log(cs.card_line())
for run in range(int(sys.argv[1])):
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        recs = hmc_cli.main([*sys.argv[2:], "--device", "cuda:0", "--results-dir", d])
    by = {r["quantity"]: round(r["value"], 3) for r in recs}
    cs.log(f"run {run}: {time.perf_counter() - t0:.1f} s; " + ", ".join(
        f"{k} {v}" for k, v in by.items() if k.startswith(("rhat", "accept"))))
