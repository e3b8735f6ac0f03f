#!/usr/bin/env python3
"""The wind cell's free fit at walks_per_node 512, seed 0, under two sets of
draws: the card against the CPU with the same draws, and the card with the
CLI's own.

On the synthetic 19x36 sphere grid of ``graphgp_tpu_torch.cli.wind`` (walk
seed 42, p_halt 0.1, L 5; 300 Adam steps at lr 0.01, 16 probes, cg_tol
1e-2; 200 pathwise samples), the free kernel is fitted and predicted three
times: on the card with the draws a CPU run of the CLI makes (the initial
modulator and every step's Rademacher probes from a CPU generator seeded 0,
the pathwise noise from one seeded 1000), on the card with the CLI's draws
from CUDA generators of the same seeds, and on the CPU with the CPU's
draws. Each line gives the initial and fitted modulator, the first and last
loss and the test RMSE: the first and third agree when the card computes
what the CPU does, and the second shows what the draw alone changes.

Usage: python3 benchmarks/torch_wind_draws.py   (needs a CUDA card; run from the repo's root)
"""
from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from graphgp_tpu_torch.cli import wind  # noqa: E402
from graphgp_tpu_torch.gp import iterative  # noqa: E402
from graphgp_tpu_torch.gp import params as P  # noqa: E402
from graphgp_tpu_torch.kernels import features_for_adjacency  # noqa: E402
from graphgp_tpu_torch.linalg import rademacher_probes  # noqa: E402

WPN, STEPS, SAMPLES, SEED = 512, 300, 200, 0
SETTINGS = iterative.CGSettings(cg_tol=1e-2, cg_max_iters=100, num_probes=16)


def problem():
    lat = np.linspace(-90, 90, 19)
    lon = np.linspace(-180, 180, 36, endpoint=False)
    adj = wind.build_sphere_grid_graph(lat, lon)
    y_raw = wind.synthetic_wind_speed(lat, lon)
    track = wind.orbit_track_nodes(lat, lon)
    y = torch.from_numpy(((y_raw - y_raw.mean()) / (y_raw.std() + 1e-12)).astype(np.float32))
    te = np.setdiff1d(np.arange(adj.shape[0]), track)
    return adj, y, torch.from_numpy(track.astype(np.int64)), torch.from_numpy(te.astype(np.int64))


def cpu_draws(n, n_train):
    """The draws of a CPU run of the CLI, in the order it makes them."""
    g = torch.Generator().manual_seed(SEED)
    init = P.init_params("free", 5, generator=g)
    probes = torch.stack([rademacher_probes(n, SETTINGS.num_probes, g, "cpu")
                          for _ in range(STEPS)])
    g2 = torch.Generator().manual_seed(1000 + SEED)
    eps1 = torch.randn((SAMPLES, n), generator=g2)
    eps2 = torch.randn((SAMPLES, n_train), generator=g2)
    return init, probes, eps1, eps2


def run(dev, adj, y, tr, te, draws):
    feats = features_for_adjacency(adj, 42 + SEED, walks_per_node=WPN, p_halt=0.1,
                                   max_walk_length=5, device=dev)
    y, tr, te = y.to(dev), tr.to(dev), te.to(dev)
    if draws is None:
        init = P.init_params("free", 5, generator=torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
        res = iterative.fit(feats, tr, y[tr], kind="free", learning_rate=0.01, num_steps=STEPS,
                            settings=SETTINGS,
                            generator=torch.Generator(device=dev).manual_seed(SEED))
        samples = iterative.pathwise_predict(
            feats, res.params, tr, y[tr], te, kind="free", num_samples=SAMPLES,
            settings=SETTINGS, generator=torch.Generator(device=dev).manual_seed(1000 + SEED))
    else:
        init, probes, eps1, eps2 = draws
        res = iterative.fit(feats, tr, y[tr], kind="free", learning_rate=0.01, num_steps=STEPS,
                            settings=SETTINGS, init={k: v.to(dev) for k, v in init.items()},
                            probes=probes.to(dev))
        samples = iterative.pathwise_predict(
            feats, res.params, tr, y[tr], te, kind="free", num_samples=SAMPLES,
            settings=SETTINGS, eps1=eps1.to(dev), eps2=eps2.to(dev))
    mean = iterative.summarize_samples(samples).mean
    rmse = float(torch.sqrt(torch.mean((mean - y[te]) ** 2)))
    print(f"{dev}, {'the CPU run' if draws is not None else 'its own'} draws: modulator "
          f"{init['modulator'].cpu().numpy().round(3)} -> "
          f"{res.params['modulator'].cpu().numpy().round(3)}, loss {float(res.losses[0]):.2f} -> "
          f"{float(res.losses[-1]):.2f}, rmse {rmse:.4f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    adj, y, tr, te = problem()
    draws = cpu_draws(adj.shape[0], tr.numel())
    run("cuda", adj, y, tr, te, draws)
    run("cuda", adj, y, tr, te, None)
    run("cpu", adj, y, tr, te, draws)
    return 0


if __name__ == "__main__":
    sys.exit(main())
