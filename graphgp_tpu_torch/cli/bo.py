"""Bayesian-optimization driver: algorithm × seed sweep on synthetic graphs
and on datasets.

Counterpart of ``graphgp_tpu/cli/bo.py``. ``--graph-type`` / ``--datasets``
take a synthetic generator's name or a dataset of
``data.database.GraphDataLoader``, read from its cache under
``processed_data/`` (``facebook`` ships there); the loader needs the
directory of raw files, which ``GRAPHGP_DATA_ROOT`` names and which must
exist. ``--config`` folds a YAML file into the flags' defaults.

A graph that fails to load or preprocess adds a row ``{"graph_type",
"error"}``, a failed (algorithm, seed) cell a row ``{"graph_type",
"algorithm", "seed", "error"}``, and the sweep goes on; the summary leaves
error rows out and the count of them is printed. A cell is run once: there
is no retry with another implementation.

Usage:
    python -m graphgp_tpu_torch.cli.bo --graph-type grid --n-nodes 1000000 \
        --algorithms random_search grf_thompson --iterations 50 --batch-size 100
    GRAPHGP_DATA_ROOT=<an existing directory> python -m graphgp_tpu_torch.cli.bo \
        --graph-type facebook --algorithms grf_thompson --walks-per-node 500 --gaussianize
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np

from ..utils.config import add_config_flag, parse_with_config


def gaussianize(y: np.ndarray) -> np.ndarray:
    """Rank-based inverse-normal transform of the targets."""
    from scipy import stats

    ranks = stats.rankdata(y)
    return stats.norm.ppf(ranks / (len(y) + 1)).astype(np.float32)


def _error_text(e: Exception, max_chars: int = 12000) -> str:
    """An error row's text, keeping the tail of a long message (where a
    compiler or allocator puts its diagnosis)."""
    msg = f"{type(e).__name__}: {e}"
    if len(msg) <= max_chars:
        return msg
    return msg[:2000] + "\n...[middle truncated]...\n" + msg[-(max_chars - 2000):]


def _print_error(prefix: str, e: Exception, lines: int = 15) -> None:
    body = f"{type(e).__name__}: {e}".splitlines()
    if len(body) > lines + 1:
        body = body[:1] + ["  ..."] + body[-lines:]
    print(f"!! {prefix} failed:")
    for ln in body:
        print(f"   {ln}")


def make_algorithm(name, data, feats, args, rng):
    from ..bo import BFS, DFS, GreedySearch, GRFThompson, RandomSearch
    from ..gp import iterative

    n = data["y_observed"].shape[0]
    if name == "random_search":
        return RandomSearch(n, rng)
    if name == "bfs":
        return BFS(data["adjacency"], n, rng)
    if name == "dfs":
        return DFS(data["adjacency"], n, rng)
    if name == "greedy_search":
        return GreedySearch(data["adjacency"], n, rng)
    if name == "grf_thompson":
        return GRFThompson(
            feats, n, rng, kind=args.kernel_kind, learning_rate=args.learning_rate,
            train_epochs=args.train_epochs, retrain_interval=args.gp_retrain_interval,
            settings=iterative.CGSettings(cg_tol=args.cg_tol, cg_max_iters=100),
            observation_capacity=args.initial_points + args.iterations * args.batch_size,
            device=args.device,
        )
    raise ValueError(f"unknown algorithm {name!r}")


def load_graph(graph_type: str, n_nodes: int, seed: int) -> Dict:
    """A synthetic graph by generator name, else a dataset by registry name."""
    from ..data import synthetic
    from ..data.database import GraphDataLoader

    if graph_type in synthetic.GENERATORS:
        return synthetic.generate(graph_type, n_nodes, seed=seed)
    loader = GraphDataLoader()
    if graph_type not in loader.registry:
        raise ValueError(
            f"unknown graph type {graph_type!r}; synthetic generators: "
            f"{sorted(synthetic.GENERATORS)}; datasets: {loader.available()}"
        )
    return loader(graph_type)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_flag(p)
    p.add_argument("--graph-type", default="grid",
                   help="synthetic generator or dataset name")
    p.add_argument("--datasets", nargs="+", default=None,
                   help="sweep several graph types (overrides --graph-type)")
    p.add_argument("--n-nodes", type=int, default=1024)
    p.add_argument("--algorithms", nargs="+",
                   default=["random_search", "bfs", "dfs", "greedy_search", "grf_thompson"])
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--bo-seeds", type=int, nargs="+", default=None,
                   help="explicit BO seeds (overrides --runs; the reference uses 100+10i)")
    p.add_argument("--initial-points", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--walks-per-node", type=int, default=1000)
    p.add_argument("--p-halt", type=float, default=0.1)
    p.add_argument("--max-walk-length", type=int, default=5)
    p.add_argument("--kernel-kind", default="free")
    p.add_argument("--learning-rate", type=float, default=0.1)
    p.add_argument("--train-epochs", type=int, default=30)
    p.add_argument("--gp-retrain-interval", type=int, default=10)
    p.add_argument("--cg-tol", type=float, default=1e-2)
    p.add_argument("--gaussianize", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--results-dir", default="artifacts/results")
    p.add_argument("--cache-dir", default="artifacts/step_matrices")
    p.add_argument("--seed", type=int, default=42)
    return p


def main(argv=None) -> List[Dict]:
    args, _cfg = parse_with_config(build_parser(), argv)

    from ..bo import run_optimization
    from ..devices import resolve_device
    from ..preprocessor import preprocess_graph
    from ..utils.io import print_summary, save_results
    from ..walker import WalkConfig

    resolve_device(args.device)
    targets = args.datasets or [args.graph_type]
    seeds = args.bo_seeds or [100 + 10 * i for i in range(args.runs)]
    needs_gp = "grf_thompson" in args.algorithms
    all_records: List[Dict] = []
    for graph_type in targets:
        try:
            data = load_graph(graph_type, args.n_nodes, args.seed)
            objective = data["y_observed"].astype(np.float32)
            if args.gaussianize:
                objective = gaussianize(objective)
            feats = None
            if needs_gp:
                cfg = WalkConfig(
                    walks_per_node=args.walks_per_node, p_halt=args.p_halt,
                    max_walk_length=args.max_walk_length,
                )
                feats = preprocess_graph(
                    data["adjacency"], cfg, seed=args.seed, cache_dir=args.cache_dir,
                    layout="auto", device=args.device,
                )
        except Exception as e:  # noqa: BLE001 -- the sweep goes on, the row records it
            _print_error(f"{graph_type}: data/preprocess", e)
            all_records.append({"graph_type": graph_type, "error": _error_text(e)})
            continue
        for algo_name in args.algorithms:
            for seed in seeds:
                try:
                    rng = np.random.default_rng(seed)
                    algo = make_algorithm(algo_name, data, feats, args, rng)
                    print(f"== {graph_type} {algo_name} seed={seed} ==")
                    result = run_optimization(
                        algo, objective, n_iterations=args.iterations,
                        initial_points=args.initial_points, batch_size=args.batch_size,
                        seed=seed,
                    )
                except Exception as e:  # noqa: BLE001 -- as above
                    _print_error(f"{graph_type}/{algo_name}/seed={seed}", e)
                    all_records.append({"graph_type": graph_type, "algorithm": algo_name,
                                        "seed": seed, "error": _error_text(e)})
                    continue
                for rec in result.records:
                    rec.update({"algorithm": algo_name, "seed": seed,
                                "graph_type": graph_type, "n_nodes": objective.shape[0]})
                all_records.extend(result.records)
                print(f"   final best={result.records[-1]['best_value']:.4f} "
                      f"regret={result.records[-1]['regret']:.4f}")

    path = save_results(all_records, args.results_dir, "bo", config=vars(args))
    final = [
        r for r in all_records if r.get("iteration") == args.iterations and "error" not in r
    ]
    if final:
        print_summary(final, ["graph_type", "algorithm"], ["best_value", "regret"])
    n_err = sum("error" in r for r in all_records)
    if n_err:
        print(f"{n_err} sweep cell(s) failed; error rows recorded")
    print(f"results -> {path}")
    return all_records


if __name__ == "__main__":
    main()
