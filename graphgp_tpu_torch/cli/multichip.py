"""Multi-device throughput harness: walks/s and CG iterations/s against the
device count.

Counterpart of ``graphgp_tpu/cli/multichip.py``, over ``torch.distributed``:
for each device count it starts that many ranks (``shard.run_ranks``: one
process a device, a file-store rendezvous in a temporary directory) and
times, on the ring of ``--n-nodes`` nodes,

  * the sharded walker (start-node blocks over the ranks, the graph on every
    rank, no collective; each rank keeps its own block, as the JAX package's
    sharded log stays sharded),
  * the distributed Gram CG (two all-reduces an iteration, tol 0, so every
    count does ``--cg-iters`` iterations),

the best of three after one warm-up call each, on rank 0. Parallel
efficiency is relative to the first count swept. ``--device cpu`` runs gloo
ranks of one thread each, at most 8 (the JAX CLI's virtual CPU platform has
8 devices); on CUDA, NCCL with one card a rank, and counts above the cards
present are dropped. With one card, the sweep is that card's throughput, not
a scaling measurement. Records name the platform so the two never mix.

Usage:
    python -m graphgp_tpu_torch.cli.multichip --devices 1
    python -m graphgp_tpu_torch.cli.multichip --device cpu --devices 1 2 4 --n-nodes 4096
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np

from ..utils.config import add_config_flag, parse_with_config

CPU_DEVICES = 8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_flag(p)
    p.add_argument("--devices", type=int, nargs="+", default=None,
                   help="device counts to sweep (default: 1, 2, 4, ... up to all available)")
    p.add_argument("--n-nodes", type=int, default=32768)
    p.add_argument("--walks-per-node", type=int, default=100)
    p.add_argument("--p-halt", type=float, default=0.1)
    p.add_argument("--max-walk-length", type=int, default=3)
    p.add_argument("--n-train", type=int, default=4096)
    p.add_argument("--cg-iters", type=int, default=50)
    p.add_argument("--cg-batch", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; NCCL, one card a rank) or 'cpu' (gloo ranks)")
    p.add_argument("--results-dir", default="artifacts/results")
    return p


def _time_best(fn, sync, repeats: int = 3) -> float:
    best = float("inf")
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _rank_sweep_point(mesh, args: Dict) -> Dict:
    """One device count, in one rank: the walk's and the CG's best seconds."""
    import torch
    import torch.distributed as dist

    from ..data.synthetic import generate_ring_data
    from ..features import LogFeatures
    from ..gp import params as P
    from ..graphs import pack_laplacian
    from ..shard import distributed_gram_solve, sharded_walk_log
    from ..walker import WalkConfig, sample_walk_log

    n = args["n_nodes"]
    graph = pack_laplacian(generate_ring_data(n, seed=0)["adjacency"]).to(mesh.device)
    cfg = WalkConfig(walks_per_node=args["walks_per_node"], p_halt=args["p_halt"],
                     max_walk_length=args["max_walk_length"])

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dist.barrier()

    def run_walk():
        sharded_walk_log(graph, 0, cfg, mesh, gather=False)

    run_walk()
    walk_s = _time_best(run_walk, sync)

    # the CG arm's features, built whole on every rank (the solve splits them)
    feats = LogFeatures(sample_walk_log(graph, 0, cfg), num_target_nodes=n)
    params = P.init_params("free", cfg.max_walk_length,
                           generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    train_idx = torch.from_numpy(np.sort(rng.choice(n, args["n_train"], replace=False)))
    b = torch.from_numpy(rng.normal(size=(args["n_train"], args["cg_batch"])).astype(np.float32))

    def run_cg():
        distributed_gram_solve(feats, params, train_idx, b, mesh, tol=0.0,
                               max_iters=args["cg_iters"])

    run_cg()
    cg_s = _time_best(run_cg, sync)
    return {"walk_s": walk_s, "cg_s": cg_s}


def main(argv=None) -> List[Dict]:
    args, _cfg = parse_with_config(build_parser(), argv)

    import torch

    from ..devices import resolve_device
    from ..shard import run_ranks
    from ..utils.io import save_results

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        n_avail, platform = torch.cuda.device_count(), "cuda"
    else:
        n_avail, platform = CPU_DEVICES, "cpu"
    devices = args.devices
    if devices is None:
        devices, d = [], 1
        while d <= n_avail:
            devices.append(d)
            d *= 2
    devices = [d for d in devices if d <= n_avail]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"platform={platform} ({name}) devices available={n_avail} sweep={devices}")

    point = {k: getattr(args, k) for k in ("n_nodes", "walks_per_node", "p_halt",
                                           "max_walk_length", "n_train", "cg_batch", "cg_iters")}
    n = args.n_nodes
    records: List[Dict] = []
    base_walk = base_cg = base_nd = None
    for nd in devices:
        got = run_ranks(_rank_sweep_point, nd, point, device=dev.type)[0]
        walks_per_s = n * args.walks_per_node / got["walk_s"]
        cg_iters_per_s = args.cg_iters / got["cg_s"]
        if base_walk is None:
            base_walk, base_cg, base_nd = walks_per_s, cg_iters_per_s, nd
        # per-device efficiency relative to the first count swept
        eff_walk = (walks_per_s / base_walk) * (base_nd / nd)
        eff_cg = (cg_iters_per_s / base_cg) * (base_nd / nd)
        records.append({
            "platform": platform,
            "n_devices": nd,
            "n_nodes": n,
            "walks_per_s": walks_per_s,
            "walk_seconds": got["walk_s"],
            "walk_parallel_efficiency": eff_walk,
            "cg_iters_per_s": cg_iters_per_s,
            "cg_seconds": got["cg_s"],
            "cg_parallel_efficiency": eff_cg,
        })
        print(f"[{nd} dev] walks/s={walks_per_s:,.0f} (eff {eff_walk:.2f})  "
              f"CG iters/s={cg_iters_per_s:.1f} (eff {eff_cg:.2f})")

    path = save_results(records, args.results_dir, "multichip", config=vars(args))
    print(f"results -> {path}")
    return records


if __name__ == "__main__":
    main()
