"""Orchestrator: the BO experiment across every synthetic graph type.

Counterpart of ``graphgp_tpu/cli/run_all.py`` (the reference's
``run_all_graphs.py``): each graph type runs in-process through
``cli.bo.main``, a type that raises is recorded and the rest go on, and all
records merge into ``bo_all_graphs.csv`` beside the per-type CSVs the bo
CLI writes. ``--device`` is passed on to the bo CLI.

Usage:
    python -m graphgp_tpu_torch.cli.run_all --n-nodes 1000000 --runs 5 --iterations 50
    python -m graphgp_tpu_torch.cli.run_all --config my.yaml --graph-types grid circle
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

from ..utils.config import add_config_flag, parse_with_config

DEFAULT_GRAPH_TYPES = [
    "circle", "grid", "periodic_grid", "staircase_grid", "grid_multimodal",
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_flag(p)
    p.add_argument("--graph-types", nargs="+", default=DEFAULT_GRAPH_TYPES)
    p.add_argument("--n-nodes", type=int, default=10_000)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument(
        "--algorithms", nargs="+",
        default=["random_search", "bfs", "dfs", "greedy_search", "grf_thompson"],
    )
    p.add_argument("--walks-per-node", type=int, default=1000)
    p.add_argument("--max-walk-length", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--initial-points", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--results-dir", default="artifacts/results")
    p.add_argument("--cache-dir", default="artifacts/step_matrices")
    return p


def main(argv=None) -> List[Dict]:
    args, _cfg = parse_with_config(build_parser(), argv)

    from ..devices import resolve_device
    from ..utils.io import print_summary, save_results
    from . import bo

    resolve_device(args.device)
    statuses: Dict[str, str] = {}
    combined: List[Dict] = []
    t_total = time.time()
    for graph_type in args.graph_types:
        print(f"\n{'=' * 60}\nRUNNING {graph_type.upper()} ({args.n_nodes} nodes)\n{'=' * 60}")
        t0 = time.time()
        try:
            records = bo.main([
                "--graph-type", graph_type,
                "--n-nodes", str(args.n_nodes),
                "--runs", str(args.runs),
                "--iterations", str(args.iterations),
                "--algorithms", *args.algorithms,
                "--walks-per-node", str(args.walks_per_node),
                "--max-walk-length", str(args.max_walk_length),
                "--batch-size", str(args.batch_size),
                "--initial-points", str(args.initial_points),
                "--device", args.device,
                "--results-dir", args.results_dir,
                "--cache-dir", args.cache_dir,
            ])
            combined.extend(records)
            failed = sum("error" in r for r in records)
            statuses[graph_type] = "ok" if not failed else f"{failed} cells failed"
            print(f"{graph_type}: done in {time.time() - t0:.1f}s")
        except Exception as e:  # noqa: BLE001 -- the other graph types still run
            statuses[graph_type] = f"FAILED: {type(e).__name__}: {e}"
            combined.append({"graph_type": graph_type, "error": f"{type(e).__name__}: {e}"})
            print(f"{graph_type}: FAILED after {time.time() - t0:.1f}s: {e}")

    path = save_results(combined, args.results_dir, "bo_all_graphs", config=vars(args))
    print(f"\n{'=' * 60}\nSUMMARY ({time.time() - t_total:.1f}s total)\n{'=' * 60}")
    for graph_type, status in statuses.items():
        print(f"  {graph_type}: {status}")
    final = [
        r for r in combined if r.get("iteration") == args.iterations and "error" not in r
    ]
    if final:
        print_summary(final, ["graph_type", "algorithm"], ["best_value", "regret"])
    print(f"combined results -> {path}")
    return combined


if __name__ == "__main__":
    main()
