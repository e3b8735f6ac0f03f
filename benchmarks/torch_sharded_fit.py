#!/usr/bin/env python3
"""``gp.iterative.fit`` over ``shard.ShardedFeatures`` against the world size:
seconds an Adam step and collectives a step, each world's losses and
parameters held against the first world's.

At the multichip CLI's ring (N 32768, walks 100, p_halt 0.1, L 3,
``LogFeatures``), every 8th node trains (4096), diffusion kind, CG tol 1e-3
and 50 iterations, 4 probes, 15 Adam steps: ``chip_smoke.py`` phase 14's fit,
with the same probes on every rank. For each world size ``shard.run_ranks``
starts one rank a device (NCCL, one card a rank; gloo ranks of one thread
with ``--device cpu``); each rank walks the whole graph, splits the features,
runs one untimed Adam step and then the timed ones between barriers. Prints
the card line and one JSON line a world size.

Usage (from the repo's root, as a module so that the ranks can import it):
    python3 -m benchmarks.torch_sharded_fit --worlds 1 2 4
    python3 -m benchmarks.torch_sharded_fit --device cpu --n-nodes 2048 --worlds 1 2 4
"""
import argparse
import json
import subprocess
import time

import numpy as np
import torch

STRIDE, WPN, P_HALT, L = 8, 100, 0.1, 3
SETTINGS = dict(cg_tol=1e-3, cg_max_iters=50, num_probes=4)


def _rank(mesh, n: int, steps: int) -> dict:
    import torch.distributed as dist

    from graphgp_tpu_torch import shard
    from graphgp_tpu_torch.data.synthetic import generate_ring_data
    from graphgp_tpu_torch.features import LogFeatures
    from graphgp_tpu_torch.gp import iterative
    from graphgp_tpu_torch.gp import params as P
    from graphgp_tpu_torch.graphs import pack_laplacian
    from graphgp_tpu_torch.walker import WalkConfig, sample_walk_log

    dev = mesh.device
    data = generate_ring_data(n, seed=0)
    graph = pack_laplacian(data["adjacency"]).to(dev)
    split = shard.sharded_features(
        LogFeatures(sample_walk_log(graph, 0, WalkConfig(WPN, P_HALT, L)), n), mesh)
    idx = torch.arange(0, n, STRIDE, device=dev)
    y = torch.from_numpy(data["y_observed"].astype(np.float32)).to(dev)[idx]
    gen = torch.Generator().manual_seed(7)
    probes = (torch.randint(0, 2, (steps, SETTINGS["num_probes"], n), generator=gen)
              * 2.0 - 1.0).to(dev)
    settings = iterative.CGSettings(**SETTINGS)
    init = P.init_params("diffusion", L, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    iterative.fit(split, idx, y, kind="diffusion", init=init, num_steps=1, settings=settings,
                  probes=probes)
    sync()
    before = (shard.all_reduces, shard.all_gathers)
    t0 = time.perf_counter()
    res = iterative.fit(split, idx, y, kind="diffusion", init=init, num_steps=steps,
                        settings=settings, probes=probes)
    sync()
    seconds = time.perf_counter() - t0
    return {"losses": res.losses.cpu(), "params": {k: v.cpu() for k, v in res.params.items()},
            "step_s": seconds / steps,
            "all_reduces": (shard.all_reduces - before[0]) / steps,
            "all_gathers": (shard.all_gathers - before[1]) / steps}


def main() -> None:
    from graphgp_tpu_torch.shard import run_ranks

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-nodes", type=int, default=32768)
    p.add_argument("--steps", type=int, default=15)
    args = p.parse_args()
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()
        print(f"{card[0]} x{len(card)}", flush=True)
    first = None
    for world in args.worlds:
        outs = run_ranks(_rank, world, args.n_nodes, args.steps, device=args.device)
        same = all(torch.equal(o["losses"], outs[0]["losses"]) for o in outs)
        out = outs[0]
        first = first or out
        rel = float(((out["losses"] - first["losses"]).abs() / first["losses"].abs()).max())
        param = max(float((out["params"][k] - first["params"][k]).abs().max())
                    for k in out["params"])
        print(json.dumps({
            "world": world, "device": args.device, "n_nodes": args.n_nodes, "steps": args.steps,
            "adam_step_s": max(o["step_s"] for o in outs),
            "all_reduces_a_step": out["all_reduces"], "all_gathers_a_step": out["all_gathers"],
            "loss_first": float(out["losses"][0]), "loss_last": float(out["losses"][-1]),
            "ranks_equal": same, "loss_rel_to_first_world": rel,
            "param_abs_to_first_world": param}), flush=True)


if __name__ == "__main__":
    main()
