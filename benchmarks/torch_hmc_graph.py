#!/usr/bin/env python3
"""The HMC trajectory replayed from a CUDA graph against the same trajectory
launched from the host, on the card.

The HMC driver's posterior at its defaults (20x20 grid, 200 train, wpn 500,
L 5, diffusion, step matrices from the CPU walker), its mode refined by
L-BFGS, then ``gp.hmc.sample_laplace`` for 30 warmup and 30 sampling
iterations of 48 leapfrog steps, 4 chains, the same draws, in turns: host
launches, graph, graph, host launches (the host-launch runs replace
``hmc._graphed_trajectory`` with the plain ``_trajectory``). Prints each
run's seconds and batched evaluations a second, and the graph's samples,
step-size trace and accept decisions against the host-launched run's.

Usage: python3 benchmarks/torch_hmc_graph.py   (needs a CUDA card; run from the repo's root)
"""
import sys
import time

sys.path.insert(0, ".")
import numpy as np
import torch

import chip_smoke as cs
from graphgp_tpu_torch.cli import hmc as hmc_cli
from graphgp_tpu_torch.data import synthetic
from graphgp_tpu_torch.features import DenseFeatures
from graphgp_tpu_torch.gp import exact, hmc
from graphgp_tpu_torch.gp import params as P
from graphgp_tpu_torch.kernels import features_for_adjacency

torch.backends.cuda.matmul.allow_tf32 = False
dev = "cuda:0"
cs.log(cs.card_line())
d = hmc_cli.build_parser().parse_args([])
data = synthetic.generate(d.graph_type, d.n_nodes, seed=0)
tr = np.sort(np.random.default_rng(0).permutation(d.n_nodes)[:200])
cpu = features_for_adjacency(data["adjacency"], 42, walks_per_node=500, p_halt=0.1,
                             max_walk_length=5, device="cpu")
feats = DenseFeatures(cpu.step_matrices.to(dev))
idx = torch.from_numpy(tr.astype(np.int64)).to(dev)
y = torch.from_numpy(np.asarray(data["y_observed"], np.float32)).to(dev)[idx]
lp = hmc.make_gp_log_posterior(lambda q: exact.mll(feats, q, idx, y, kind="diffusion"),
                               anchors={"raw_noise": (-2.0, 0.5)})
mode, _ = hmc.refine_mode(lp, {k: v.to(dev) for k, v in P.init_params("diffusion", 5, noise=0.3).items()})
cfg = hmc.HMCConfig(num_warmup=30, num_samples=30, num_leapfrog=48, initial_step_size=0.1)
draws = hmc.draw(4, 60, 3, torch.Generator().manual_seed(0))
graphed = hmc._graphed_trajectory
runs = {}
for name in ("eager", "graph", "graph", "eager"):
    if name == "eager":
        hmc._graphed_trajectory = lambda vg, n, ex: (lambda *a: hmc._trajectory(vg, *a[:5], n, a[5]))
    else:
        hmc._graphed_trajectory = graphed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = hmc.sample_laplace(lp, mode, config=cfg, num_chains=4, draws=draws)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    runs.setdefault(name, []).append((dt, res))
    cs.log(f"{name}: {dt:.2f} s for 60 iterations x 48 leapfrog steps, "
           f"{60 * 48 / dt:.1f} batched evaluations a second")
hmc._graphed_trajectory = graphed
a, b = runs["eager"][0][1], runs["graph"][0][1]
for k in a.samples:
    _, rel = cs.rel_err(b.samples[k], a.samples[k])
    cs.log(f"graph against eager, {k}: rel {rel:.2e}")
_, rel = cs.rel_err(b.eps_trace, a.eps_trace)
cs.log(f"eps trace rel {rel:.2e}; accept equal {bool(torch.equal(a.accept_trace, b.accept_trace))}")
