"""Back-to-back GRF feature builds of one graph, each from a fresh walk seed.

Set-up makes the graph from the seed and warms with one build on a
throwaway walk seed. The window ends at the first build boundary at or
after ``--seconds``. ``features_s`` is the window's wall time over the
builds. One build drawn from the seed (reservoir sampling over the window)
and the last build are judged: their ELL rows and their layout at sampled
rows and columns are read as the build finishes.
"""
from __future__ import annotations

import time

import numpy as np

from gpbench.core import program


def setup(cell) -> None:
    s = cell.state
    with cell.probes.span("graph"):
        s["adjacency"] = program.load_graph(cell)["adjacency"]
    program.install_layout_span(cell)
    program.build_features(cell, s["adjacency"], cell.seeds.draw("warm"), {})
    s["n"] = s["adjacency"].shape[0]
    rng = cell.seeds.rng("check")
    s["rows"] = np.sort(rng.choice(s["n"], size=min(64, s["n"]), replace=False))
    s["cols"] = np.sort(rng.choice(s["n"], size=min(16, s["n"]), replace=False))


def _judged(cell, feats, trace, walk_seed) -> dict:
    s = cell.state
    w = cell.config["walks"]
    rec = {"adjacency": s["adjacency"],
           "walks": {"seed": walk_seed, "walks_per_node": w["walks_per_node"],
                     "p_halt": w["p_halt"], "length": w["max_walk_length"]},
           "sample_rows": s["rows"], "sample_cols": s["cols"]}
    rec.update(program.layout_record(feats, trace.get("ell"), s["rows"], s["cols"]))
    return rec


def window(cell, seconds: float) -> int:
    s = cell.state
    pick = cell.seeds.rng("reservoir")
    builds = cell.probes.captures.setdefault("builds", [])
    t0 = time.perf_counter()
    k = 0
    while True:
        walk_seed = cell.seeds.draw("walks", k)
        trace: dict = {}
        feats = program.build_features(cell, s["adjacency"], walk_seed, trace)
        builds.append({key: v for key, v in trace.items() if key.endswith("_s")})
        if pick.random() * (k + 1) < 1.0:
            s["sampled"] = _judged(cell, feats, trace, walk_seed)
        k += 1
        if time.perf_counter() - t0 >= seconds:
            s["last"] = (feats, trace, walk_seed)
            return k
        del feats, trace


def e2e(cell, units: int, seconds: float) -> dict:
    return {"features_s": seconds / units}


def record(cell) -> list:
    s = cell.state
    last = _judged(cell, *s.pop("last"))
    return [s["sampled"], last] if s["sampled"]["walks"]["seed"] != last["walks"]["seed"] \
        else [last]
