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
error rows out and the count of them is printed. A cell is never retried on
another implementation.

``--isolate`` runs each (dataset, algorithm, seed) cell in a child process
of its own, ``--cell-timeout`` seconds at most (the child is killed then),
and runs a failed cell once more, the same command: after an illegal
address or a device-side assert a process's CUDA context is lost for good,
and a kernel or a collective that never returns has no other guard. A child
that fails twice, or writes only error rows, leaves one error row naming its
exit code or the timeout.

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


# Flags forwarded verbatim to an isolated cell's child process.
_CELL_FLAGS = [
    ("n_nodes", "--n-nodes"), ("iterations", "--iterations"),
    ("initial_points", "--initial-points"), ("batch_size", "--batch-size"),
    ("walks_per_node", "--walks-per-node"), ("p_halt", "--p-halt"),
    ("max_walk_length", "--max-walk-length"), ("kernel_kind", "--kernel-kind"),
    ("learning_rate", "--learning-rate"), ("train_epochs", "--train-epochs"),
    ("gp_retrain_interval", "--gp-retrain-interval"), ("cg_tol", "--cg-tol"),
    ("cache_dir", "--cache-dir"), ("seed", "--seed"), ("device", "--device"),
]


def _parse_cell(value: str):
    """A CSV field back as the number or string it was written from."""
    try:
        return float(value) if "." in value or "e" in value.lower() else int(value)
    except ValueError:
        return value


def _run_cell(cmd: List[str], cell_dir: str, timeout: float):
    """One child run of a cell: (its rows, "") or (None, why it failed). The
    child finds this package where this process found it."""
    import csv
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired as e:  # run() has killed the child
        out = e.stdout.decode(errors="replace") if isinstance(e.stdout, bytes) else e.stdout
        return None, f"cell rc=timeout\ncell timeout after {timeout}s\n{out or ''}"
    csv_path = os.path.join(cell_dir, "bo.csv")
    if proc.returncode != 0 or not os.path.exists(csv_path):
        tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-15:])
        return None, f"cell rc={proc.returncode}\n{tail}"
    with open(csv_path, newline="") as fh:
        rows = [{k: _parse_cell(v) for k, v in r.items() if v not in (None, "")}
                for r in csv.DictReader(fh)]
    if all("error" in r for r in rows):  # a child that recorded only error rows failed
        return None, "\n".join(str(r.get("error", "")) for r in rows)
    return rows, ""


def _run_isolated(args, targets: List[str], seeds: List[int]) -> List[Dict]:
    """Every (dataset, algorithm, seed) cell in a child process of its own,
    run a second time, the same command, if the first run fails."""
    import os
    import sys

    records: List[Dict] = []
    for graph_type in targets:
        for algo_name in args.algorithms:
            for seed in seeds:
                cell = f"{graph_type}_{algo_name}_{seed}"
                cell_dir = os.path.join(args.results_dir, ".cells", cell)
                cmd = [sys.executable, "-u", "-m", "graphgp_tpu_torch.cli.bo",
                       "--graph-type", str(graph_type), "--algorithms", algo_name,
                       "--bo-seeds", str(seed), "--results-dir", cell_dir]
                for attr, flag in _CELL_FLAGS:
                    cmd += [flag, str(getattr(args, attr))]
                if args.gaussianize:
                    cmd.append("--gaussianize")
                for attempt in range(2):
                    print(f"== cell {cell}{' [retry]' if attempt else ''} ==", flush=True)
                    rows, err = _run_cell(cmd, cell_dir, args.cell_timeout)
                    if rows is not None:
                        break
                    print(f"!! cell {cell} failed (attempt {attempt + 1}):")
                    for ln in err.splitlines()[-8:]:
                        print(f"   {ln}")
                if rows is None:
                    records.append({"graph_type": graph_type, "algorithm": algo_name,
                                    "seed": seed, "error": err[-8000:]})
                    continue
                records.extend(rows)
                final = [r for r in rows if r.get("iteration") == args.iterations]
                if final:
                    print(f"   final best={final[-1].get('best_value')} "
                          f"regret={final[-1].get('regret')}")
    return records


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
    p.add_argument("--isolate", action="store_true",
                   help="run each (dataset, algorithm, seed) cell in a child process, "
                        "retried once: a lost CUDA context or a hung kernel ends one cell, "
                        "not the sweep")
    p.add_argument("--cell-timeout", type=int, default=5400,
                   help="seconds a cell's child may run under --isolate")
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


def _run_in_process(args, targets: List[str], seeds: List[int]) -> List[Dict]:
    """Every cell in this process; a failed graph or cell is an error row."""
    from ..bo import run_optimization
    from ..preprocessor import preprocess_graph
    from ..walker import WalkConfig

    needs_gp = "grf_thompson" in args.algorithms
    records: List[Dict] = []
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
            records.append({"graph_type": graph_type, "error": _error_text(e)})
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
                    records.append({"graph_type": graph_type, "algorithm": algo_name,
                                    "seed": seed, "error": _error_text(e)})
                    continue
                for rec in result.records:
                    rec.update({"algorithm": algo_name, "seed": seed,
                                "graph_type": graph_type, "n_nodes": objective.shape[0]})
                records.extend(result.records)
                print(f"   final best={result.records[-1]['best_value']:.4f} "
                      f"regret={result.records[-1]['regret']:.4f}")
    return records


def main(argv=None) -> List[Dict]:
    args, _cfg = parse_with_config(build_parser(), argv)

    from ..devices import resolve_device
    from ..utils.io import print_summary, save_results

    resolve_device(args.device)
    targets = args.datasets or [args.graph_type]
    seeds = args.bo_seeds or [100 + 10 * i for i in range(args.runs)]
    run = _run_isolated if args.isolate else _run_in_process
    all_records = run(args, targets, seeds)

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
