"""Back-to-back GRF-Thompson BO runs, one client in a closed loop.

Set-up makes the graph, its objective and its features (the
configuration's data and walk seeds), and warms every shape with one BO
iteration on a throwaway BO seed, its fit cut to one Adam step (every step
of a fit has the same shapes). The window is made of whole passes over the
traffic's ``bo_seeds``, one BO run each, in an order drawn from ``--seed``,
so that every seed times the same work (runs of different BO seeds differ
in work); it ends at the end of the first pass at or after ``--seconds``.
A run is the configuration's ``iterations`` of
``select → evaluate → update`` at the traffic's ``batch_size``. ``--seed``
also draws the positions the check reads.

``bo_iter_s`` (or the name the mix gives, ``metric``) is the window's wall
time over the iterations completed in it.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from gpbench.core import program


def setup(cell) -> None:
    s = cell.state
    with cell.probes.span("graph"):
        g = program.load_graph(cell)
    s["adjacency"], s["objective"] = g["adjacency"], g["objective"]
    program.install_layout_span(cell)
    s["feats"] = program.build_features(cell, s["adjacency"], cell.config["seeds"]["walks"], {})
    program.install_gp_probes(cell)
    if cell.probes.traced:
        program.install_operator_counters(cell, s["feats"])
    warm = cell.seeds.draw("warm")
    algo = program.make_thompson(cell, s["adjacency"], s["feats"], warm, train_epochs=1)
    _select_probe(cell, algo)
    with cell.probes.span("warm"):
        program.run_bo(cell, algo, s["objective"], warm, iterations=1)


def _select_probe(cell, algo) -> None:
    select = algo.select_next_points

    def wrapper(observed_idx, observed_y, batch_size=1):
        cell.probes.captures["observed_now"] = np.asarray(observed_idx).copy()
        with cell.probes.span("select"):
            picks = select(observed_idx, observed_y, batch_size)
        cell.probes.captures["select"] = {"observed": np.asarray(observed_idx), "picks": picks}
        return picks

    algo.select_next_points = wrapper


def passes(cell, seconds: float):
    """The BO seeds of the window in order: whole passes over the mix's
    list until ``seconds`` have passed."""
    order = cell.seeds.rng("order").permutation(cell.traffic["bo_seeds"]).tolist()
    t0 = time.perf_counter()
    while True:
        yield from order
        if time.perf_counter() - t0 >= seconds:
            return


def window(cell, seconds: float) -> int:
    s = cell.state
    iterations = cell.config["bo"]["iterations"]
    counters = cell.probes.counters
    runs = 0
    for bo_seed in passes(cell, seconds):
        t0, cg0 = time.perf_counter(), counters["cg.iterations"]
        algo = program.make_thompson(cell, s["adjacency"], s["feats"], bo_seed)
        _select_probe(cell, algo)
        program.run_bo(cell, algo, s["objective"], bo_seed, iterations)
        phases = cell.probes.captures.setdefault("phase_seconds", {"fit": [], "draw": []})
        for k in phases:
            phases[k].extend(algo.phase_seconds[k])
        runs += 1
        print(f"run: BO seed {bo_seed}, {time.perf_counter() - t0:.3f} s, "
              f"{int(counters['cg.iterations'] - cg0)} CG iterations, "
              f"{len(algo.phase_seconds['fit'])} fits", file=sys.stderr)
    return runs * iterations


def e2e(cell, units: int, seconds: float) -> dict:
    """The window's seconds per BO iteration, under the name the mix gives
    its rate (cells whose host-bound runs spread more between processes
    report it under a name of their own, with a bound of its own)."""
    return {cell.traffic["metric"]: seconds / units}


def _fit_record(cap, cpu) -> dict:
    solve = cap.get("solve") or {}
    return {"params": {k: cpu(v) for k, v in cap["params"].items()},
            "params_after": {k: cpu(v) for k, v in cap.get("params_after", {}).items()},
            "grad": {k: cpu(v) for k, v in cap["grad"].items()},
            "train_idx": cpu(cap["train_idx"]).numpy(), "mask": cpu(cap["mask"]),
            "observed": cap["observed"],
            "y": cpu(cap["y"]), "probes": cpu(cap["probes"]), "alpha": cpu(cap["alpha"]),
            "mll": float(cap["mll"]), "num_real": float(cap["num_real"]),
            "lanczos_iters": cap["lanczos_iters"],
            "iterations": solve.get("iterations"),
            "recurrence": None if solve.get("residual") is None else float(solve["residual"])}


def record(cell) -> list:
    """The reference's record: the features at sampled rows and columns,
    the first objective, gradient and Adam step of the last run's first fit
    and of its last refit, the last Thompson draw and its picks."""
    s = cell.state
    caps = cell.probes.captures
    n = s["feats"].num_nodes
    rng = cell.seeds.rng("check")
    rows = np.sort(rng.choice(n, size=min(64, n), replace=False))
    cols = np.sort(rng.choice(n, size=min(16, n), replace=False))
    w = cell.config["walks"]
    b = cell.config["bo"]
    rec = {"adjacency": s["adjacency"], "objective": s["objective"],
           "walks": {"seed": cell.config["seeds"]["walks"], "walks_per_node": w["walks_per_node"],
                     "p_halt": w["p_halt"], "length": w["max_walk_length"]},
           "solver": {"cg_tol": b["cg_tol"], "cg_max_iters": b["cg_max_iters"],
                      "learning_rate": b["learning_rate"]},
           "sample_rows": rows, "sample_cols": cols}
    rec.update(program.layout_record(s["feats"], None, rows, cols))

    d, sel = caps["draw"], caps["select"]
    picks = np.asarray(sel["picks"], dtype=np.int64)
    scores = d["sample"][0].detach().cpu()
    cpu = lambda t: None if t is None else t.detach().cpu()  # noqa: E731
    solve = d["solve"]
    rec["draw"] = {"params": {k: cpu(v) for k, v in d["params"].items()},
                   "train_idx": cpu(d["train_idx"]).numpy(), "mask": cpu(d["mask"]),
                   "observed": d["observed"],
                   "y": cpu(d["y"]), "eps1": d["eps1"], "eps2": cpu(d["eps2"]),
                   "x": cpu(solve["x"]), "scores": scores,
                   "iterations": solve["iterations"],
                   "recurrence": float(solve["residual"].max()),
                   "rows": np.unique(np.concatenate([rows, picks]))}
    rec["phi"] = {"params": rec["draw"]["params"],
                  "forward": d["products"].get("forward"),
                  "transposed": d["products"].get("transposed")}
    rec["fit"] = _fit_record(caps["fit"], cpu)
    if "refit" in caps:
        rec["refit"] = _fit_record(caps["refit"], cpu)
    rec["pick"] = {"scores": scores, "picks": picks, "observed": sel["observed"]}
    return [rec]
