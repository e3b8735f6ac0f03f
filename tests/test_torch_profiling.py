"""The span and counter recorder (``graphgp_tpu_torch.utils.profiling``) and
the spans the port opens in the BO algorithm, the GP, the solvers and the
feature build, on the CPU: off it reads no clock and keeps nothing; on it
keeps the expected tree, counts each solver iteration and host sync inside
the fit it fell in, and shares the profiler's clock."""
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphgp_tpu_torch import linalg
from graphgp_tpu_torch.bo.algorithms import GRFThompson
from graphgp_tpu_torch.features import DenseFeatures, EllFeatures, StencilFeatures, ell_to_dense
from graphgp_tpu_torch.gp import iterative
from graphgp_tpu_torch.gp.iterative import CGSettings
from graphgp_tpu_torch.preprocessor import preprocess_graph
from graphgp_tpu_torch.utils import profiling
from graphgp_tpu_torch.walker import WalkConfig

CFG = WalkConfig(walks_per_node=16, p_halt=0.1, max_walk_length=3)
SETTINGS = CGSettings(cg_tol=1e-2, cg_max_iters=100, num_probes=4, num_lanczos_iters=5)


def _grid(side=10):
    idx = np.arange(side * side).reshape(side, side)
    u = np.r_[idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    v = np.r_[idx[:, 1:].ravel(), idx[1:, :].ravel()]
    a = sp.coo_matrix((np.ones(2 * u.size), (np.r_[u, v], np.r_[v, u])),
                      shape=(side * side,) * 2)
    return a.tocsr()


def _skewed(n=300):
    rng = np.random.default_rng(0)
    u = np.concatenate([np.zeros(60, int), rng.integers(0, n, 600)])
    v = np.concatenate([np.arange(1, 61), rng.integers(0, n, 600)])
    keep = u != v
    a = sp.coo_matrix((np.ones(keep.sum() * 2), (np.r_[u[keep], v[keep]],
                                                 np.r_[v[keep], u[keep]])), shape=(n, n)).tocsr()
    a.data[:] = 1.0
    return a


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def feats():
    # a small log budget takes the blocked pipeline (capacity probe, blocks)
    return preprocess_graph(_grid(), CFG, seed=1, layout="auto", device="cpu",
                            log_budget_bytes=2000)


def _problem(feats, n_train=12):
    n = feats.num_nodes
    train = torch.arange(0, n, n // n_train)[:n_train]
    y = torch.sin(train.to(torch.float32))
    return train, y, torch.ones(n_train)


def _fit(feats, steps=2):
    train, y, mask = _problem(feats)
    return iterative.fit(feats, train, y, num_steps=steps, settings=SETTINGS, mask=mask,
                         num_real=float(mask.numel()), generator=torch.Generator().manual_seed(0))


def _predict(feats, params):
    train, y, mask = _problem(feats)
    return iterative.pathwise_predict(feats, params, train, y, torch.arange(feats.num_nodes),
                                      num_samples=2, settings=SETTINGS, mask=mask,
                                      generator=torch.Generator().manual_seed(1))


def _tree(snap):
    """name -> set of parent names, over the snapshot's spans."""
    by_id = {s["id"]: s for s in snap["spans"]}
    out = {}
    for s in snap["spans"]:
        parent = by_id.get(s["parent"])
        out.setdefault(s["name"], set()).add(parent["name"] if parent else None)
    return out


def test_off_reads_no_clock_and_keeps_nothing(feats, monkeypatch):
    def clock():
        raise AssertionError("the recorder read its clock while off")

    monkeypatch.setattr(profiling, "_clock", clock)
    res = _fit(feats)
    _predict(feats, res.params)
    preprocess_graph(_grid(), CFG, seed=2, layout="auto", device="cpu", log_budget_bytes=2000)
    preprocess_graph(_skewed(), CFG, seed=2, layout="auto", device="cpu")
    assert profiling.snapshot() == {"spans": [], "counts": {}}
    assert profiling.span("x") is profiling.span("y")
    assert profiling.timed("x", needed=False) is profiling.span("x")


def test_spans_nest_and_counts_roll_up():
    profiling.enable()
    with profiling.span("outer"):
        profiling.count("c", 2)
        with profiling.span("inner"):
            profiling.count("c", 3)
            profiling.count("d")
        with profiling.host_sync():
            pass
    profiling.count("c")  # outside every span: the total only
    snap = profiling.snapshot()
    outer, inner, sync = snap["spans"]
    assert [s["name"] for s in snap["spans"]] == ["outer", "inner", "sync"]
    assert outer["parent"] is None and inner["parent"] == sync["parent"] == outer["id"]
    assert inner["counts"] == {"c": 3, "d": 1}
    assert outer["counts"] == {"c": 5, "d": 1, "host.syncs": 1}
    assert snap["counts"] == {"c": 6, "d": 1, "host.syncs": 1}
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= sync["start_ns"] \
        <= sync["end_ns"] <= outer["end_ns"]
    profiling.reset()
    assert profiling.snapshot() == {"spans": [], "counts": {}}


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_a_tally_takes_this_threads_counts_and_keeps_no_span(on):
    """What a CUDA graph's capture counts goes to the tally, on or off, for
    its replays to add; another thread's counts and spans are kept."""
    import threading

    def other():
        with profiling.span("other"):
            profiling.count("c", 5)

    if on:
        profiling.enable()
    with profiling.span("outer"):
        with profiling.tally() as counts:
            with profiling.span("captured"):
                profiling.count("c", 2)
                profiling.count("d")
            t = threading.Thread(target=other)
            t.start()
            t.join()
        for name, n in counts.items():  # a replay
            profiling.count(name, n)
    assert counts == {"c": 2, "d": 1}
    snap = profiling.snapshot()
    if on:
        assert [s["name"] for s in snap["spans"]] == ["outer", "other"]
        assert snap["spans"][0]["counts"] == {"c": 2, "d": 1}
        assert snap["counts"] == {"c": 7, "d": 1}
    else:
        assert snap == {"spans": [], "counts": {}}


def test_a_lent_span_takes_in_another_threads_spans():
    import threading

    def work():  # as autograd's thread for a card runs a backward pass
        with profiling.span("cg"):
            profiling.count("cg.iterations", 7)
        profiling.count("host.syncs")

    profiling.enable()
    with profiling.span("gp.step"):
        with profiling.span("gp.backward", lend=True):
            t = threading.Thread(target=work)
            t.start()
            t.join()
        with profiling.span("gp.adam"):
            t = threading.Thread(target=work)  # nothing lent: a span of its own
            t.start()
            t.join()
    step, backward, cg, adam, cg2 = profiling.snapshot()["spans"]
    assert cg["parent"] == backward["id"] and backward["parent"] == step["id"]
    assert backward["counts"] == {"cg.iterations": 7, "host.syncs": 1}
    assert cg2["parent"] is None and adam["counts"] == {}
    assert step["counts"] == {"cg.iterations": 7, "host.syncs": 1}


def test_threads_lose_no_count_or_span():
    import sys
    import threading

    threads, rounds = 16, 300

    def work():
        for _ in range(rounds):
            with profiling.span("w"):
                profiling.count("n")
            profiling.count("n")

    profiling.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.span("outer", lend=True):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    snap = profiling.snapshot()
    total = threads * rounds * 2
    assert snap["counts"] == {"n": total}
    outer = [s for s in snap["spans"] if s["name"] == "outer"][0]
    assert outer["counts"] == {"n": total}
    ids = [s["id"] for s in snap["spans"]]
    assert len(ids) == len(set(ids)) == threads * rounds + 1


def test_fit_and_predict_keep_the_span_tree(feats):
    profiling.enable()
    res = _fit(feats)
    _predict(feats, res.params)
    tree = _tree(profiling.snapshot())
    assert tree["gp.fit"] == {None} and tree["gp.predict"] == {None}
    assert tree["gp.step"] == {"gp.fit"}
    for child in ("gp.mll", "gp.backward", "gp.adam"):
        assert tree[child] == {"gp.step"}
    # the forward solve and the SLQ in the objective; the adjoint and the
    # probe solves in the backward pass; the draw's residual solve
    assert tree["cg"] == {"gp.mll", "gp.backward", "gp.predict.solve"}
    assert tree["lanczos"] == {"gp.mll"}
    # the solvers' flag reads, and the train blocks' counts of their columns
    assert tree["sync"] == {"cg", "gp.train_block"}
    # the fit's block, and the draw's own for its residual solve
    assert tree["gp.train_block"] == {"gp.fit", "gp.predict.solve"}
    for child in ("gp.predict.prior", "gp.predict.solve", "gp.predict.correction"):
        assert tree[child] == {"gp.predict"}


def test_the_counts_inside_a_fit_are_its_solves(feats, monkeypatch):
    solves = []
    original = linalg.batched_cg

    def counted(*args, **kwargs):
        out = original(*args, **kwargs)
        solves.append(out.iterations)
        return out

    monkeypatch.setattr(linalg, "batched_cg", counted)
    profiling.enable()
    steps = 3
    _fit(feats, steps=steps)
    snap = profiling.snapshot()
    (fit,) = [s for s in snap["spans"] if s["name"] == "gp.fit"]
    c = fit["counts"]
    assert len(solves) == 3 * steps  # the forward, adjoint and probe solves a step
    assert c["cg.solves"] == len(solves)
    assert c["cg.iterations"] == sum(solves)
    # one flag read each iteration, one more where a solve converged, and
    # the train block's count of its columns, once a fit
    assert c["host.syncs"] == sum(k + (k < SETTINGS.cg_max_iters) for k in solves) + 1
    assert c["lanczos.iterations"] == steps * SETTINGS.num_lanczos_iters
    # the CPU keeps the one-iteration loop: no solve runs as a CUDA graph
    assert "cg.graph_solves" not in c and "cg.graph_captures" not in c
    assert snap["counts"] == c
    step_counts = [s["counts"]["cg.iterations"] for s in snap["spans"] if s["name"] == "gp.step"]
    assert sum(step_counts) == c["cg.iterations"]


@pytest.fixture(scope="module")
def ell_feats():
    return preprocess_graph(_skewed(), CFG, seed=1, layout="auto", device="cpu")


@pytest.mark.parametrize("layout", ["stencil", "ell", "dense", "full_space"])
def test_a_fit_counts_its_gram_products_by_path(feats, ell_feats, layout):
    """The compact fits on the stencil and ELL layouts take every Gram
    product from the train block, built once a fit; a fit on dense features
    and a full-space fit take them from full-graph products. Off, the
    recorder keeps none of it."""
    f = {"stencil": feats, "ell": ell_feats, "full_space": feats,
         "dense": DenseFeatures(ell_to_dense(ell_feats.mats))}[layout]
    assert isinstance(feats, StencilFeatures) and isinstance(ell_feats, EllFeatures)
    steps = 2

    def run():
        if layout != "full_space":
            return _fit(f, steps=steps)
        train, y, _ = _problem(f)
        return iterative.fit(f, train, y, num_steps=steps, settings=SETTINGS, full_space=True,
                             generator=torch.Generator().manual_seed(0))

    profiling.enable()
    run()
    snap = profiling.snapshot()
    (fit,) = [s for s in snap["spans"] if s["name"] == "gp.fit"]
    c = fit["counts"]
    # each solve's iterations (a solve starts at x = 0 and applies no
    # product there), each Lanczos step, and the two adjoint rules'
    # re-evaluations a step
    products = c["cg.iterations"] + c["lanczos.iterations"] + 2 * steps
    blocks = [s for s in snap["spans"] if s["name"] == "gp.train_block"]
    if layout in ("stencil", "ell"):
        assert c["gram.train_block"] == products and "gram.full_graph" not in c
        assert len(blocks) == 1 and blocks[0]["parent"] == fit["id"]
    else:
        assert c["gram.full_graph"] == products and "gram.train_block" not in c
        assert blocks == []
    profiling.disable()
    profiling.reset()
    run()
    assert profiling.snapshot() == {"spans": [], "counts": {}}


@pytest.mark.parametrize("layout", ["stencil", "ell"])
def test_a_compact_draw_takes_its_gram_products_from_its_own_train_block(feats, ell_feats,
                                                                         layout):
    """A masked compact draw on the stencil and ELL layouts builds one train
    block, under ``gp.predict.solve``, and every Gram product of its
    residual solve comes from it: one an iteration, none at its zero start.
    The prior and the correction are Φ products, no Gram products."""
    f = feats if layout == "stencil" else ell_feats
    params = _fit(f, steps=1).params
    profiling.enable()
    _predict(f, params)
    snap = profiling.snapshot()
    (predict,) = [s for s in snap["spans"] if s["name"] == "gp.predict"]
    (solve,) = [s for s in snap["spans"] if s["name"] == "gp.predict.solve"]
    c = predict["counts"]
    assert c["cg.solves"] == 1
    assert c["gram.train_block"] == c["cg.iterations"]
    assert "gram.full_graph" not in c
    blocks = [s for s in snap["spans"] if s["name"] == "gp.train_block"]
    assert len(blocks) == 1 and blocks[0]["parent"] == solve["id"]
    assert snap["counts"]["gram.train_block"] == c["gram.train_block"]


@pytest.mark.parametrize("layout", ["stencil", "ell"])
def test_the_train_block_counts_its_entries_and_pairs_inside_the_fit(feats, ell_feats, layout):
    """``train_block.entries``: live train-row entries of the distinct train
    nodes; ``train_block.pairs``: the pairs of them that share a column, the
    products the block sums. Both land in the fit's span."""
    from graphgp_tpu_torch.features import step_rows

    f = feats if layout == "stencil" else ell_feats
    train, _, _ = _problem(f)
    cols, vals = step_rows(f, train)
    cols = np.broadcast_to(cols.numpy(), vals.shape)[vals.numpy() != 0]
    profiling.enable()
    _fit(f, steps=1)
    (fit,) = [s for s in profiling.snapshot()["spans"] if s["name"] == "gp.fit"]
    assert fit["counts"]["train_block.entries"] == cols.size
    assert fit["counts"]["train_block.pairs"] == int((np.bincount(cols) ** 2).sum())


def test_an_rgg_fit_at_the_flagship_capacity_takes_no_full_graph_product():
    """A random geometric graph's fit at the flagship's observation
    capacity, 1010 slots of which most are padding at node 0, solves on
    the train block alone: one build, and ``gram.full_graph`` reads 0."""
    from graphgp_tpu_torch.data import synthetic

    g = synthetic.generate("rgg", 4096, seed=1)
    f = preprocess_graph(g["adjacency"], CFG, seed=1, layout="auto", device="cpu")
    assert isinstance(f, EllFeatures)
    train = torch.zeros(1010, dtype=torch.int64)
    train[:110] = torch.arange(0, 4096, 37)[:110]
    mask = (torch.arange(1010) < 110).to(torch.float32)
    y = torch.from_numpy(g["y_observed"])[train] * mask
    profiling.enable()
    iterative.fit(f, train, y, num_steps=1, settings=SETTINGS, mask=mask, num_real=110.0,
                  generator=torch.Generator().manual_seed(0))
    snap = profiling.snapshot()
    (fit,) = [s for s in snap["spans"] if s["name"] == "gp.fit"]
    assert fit["counts"]["gram.train_block"] > 0
    assert fit["counts"].get("gram.full_graph", 0) == 0
    assert len([s for s in snap["spans"] if s["name"] == "gp.train_block"]) == 1


def test_the_feature_build_keeps_its_spans():
    profiling.enable()
    preprocess_graph(_grid(), CFG, seed=1, layout="auto", device="cpu", log_budget_bytes=2000)
    grid = _tree(profiling.snapshot())
    assert grid["prep.build"] == {None}
    for child in ("prep.pack_laplacian", "prep.walks", "prep.consolidate", "prep.layout"):
        assert grid[child] == {"prep.build"}
    assert grid["prep.vocabulary"] == grid["prep.stencil_build"] == {"prep.layout"}
    # the capacity probe's read and the blocks' largest row, on the host
    assert grid["sync"] == {"prep.consolidate", "prep.build"}
    builds = [s for s in profiling.snapshot()["spans"] if s["name"] == "prep.build"]
    assert builds[0]["counts"]["host.syncs"] == 2
    walks = [s for s in profiling.snapshot()["spans"] if s["name"] == "prep.walks"]
    assert len(walks) >= 3  # the probe and at least two blocks

    profiling.reset()
    preprocess_graph(_skewed(), CFG, seed=1, layout="auto", device="cpu")
    ell = _tree(profiling.snapshot())
    assert ell["prep.walks"] == ell["prep.consolidate"] == {"prep.build"}
    assert ell["prep.vocabulary"] == ell["prep.transpose"] == {"prep.layout"}
    assert "prep.stencil_build" not in ell
    assert ell["sync"] == {"prep.consolidate"}  # suggest_row_capacity's read


def _thompson(feats, epochs=2):
    return GRFThompson(feats, feats.num_nodes, np.random.default_rng(0), train_epochs=epochs,
                       retrain_interval=1, settings=SETTINGS, device="cpu")


@pytest.mark.parametrize("on", [False, True])
def test_phase_seconds_keep_their_keys_and_are_the_spans(feats, on):
    if on:
        profiling.enable()
    algo = _thompson(feats)
    observed = np.arange(0, 40, 4)
    y = np.sin(observed).astype(np.float32)
    picks = algo.select_next_points(observed, y, batch_size=3)
    algo.select_next_points(np.r_[observed, picks], np.r_[y, np.zeros(3, np.float32)], 3)
    assert list(algo.phase_seconds) == ["fit", "draw"]
    assert len(algo.phase_seconds["fit"]) == len(algo.phase_seconds["draw"]) == 2
    assert all(t > 0 for v in algo.phase_seconds.values() for t in v)
    snap = profiling.snapshot()
    if not on:
        assert snap["spans"] == []
        return
    tree = _tree(snap)
    assert tree["bo.select"] == {None}
    for child in ("bo.upload", "bo.fit", "bo.draw", "bo.pick"):
        assert tree[child] == {"bo.select"}
    assert tree["gp.fit"] == {"bo.fit"} and tree["gp.predict"] == {"bo.draw"}
    for phase in ("fit", "draw"):
        spans = [s for s in snap["spans"] if s["name"] == f"bo.{phase}"]
        assert [(s["end_ns"] - s["start_ns"]) * 1e-9 for s in spans] == \
            algo.phase_seconds[phase]
    # the scores' read in the draw, on the host
    draws = [s for s in snap["spans"] if s["name"] == "bo.draw"]
    gp_draws = [s for s in snap["spans"] if s["name"] == "gp.predict"]
    assert [d["counts"]["host.syncs"] - g["counts"]["host.syncs"]
            for d, g in zip(draws, gp_draws)] == [1, 1]


@pytest.mark.parametrize("graph,keys", [
    ("grid", {"walk_consolidate_s", "stencil_build_s", "ell"}),
    ("skewed", {"walk_consolidate_s", "vocabulary_s", "transpose_s", "ell"}),
])
@pytest.mark.parametrize("on", [False, True])
def test_the_build_trace_keeps_its_keys(graph, keys, on):
    if on:
        profiling.enable()
    trace = {}
    adj = _grid() if graph == "grid" else _skewed()
    preprocess_graph(adj, CFG, seed=3, layout="auto", device="cpu", trace=trace)
    assert set(trace) == keys
    assert all(trace[k] > 0 for k in keys if k.endswith("_s"))
    spans = {s["name"]: s for s in profiling.snapshot()["spans"]}
    if on:
        # each phase runs from its span's first reading to the end of a sync
        ends = sorted(s["end_ns"] for s in profiling.snapshot()["spans"] if s["name"] == "sync")
        start = spans["prep.pack_laplacian"]["start_ns"]
        assert any(trace["walk_consolidate_s"] == (e - start) * 1e-9 for e in ends)
        assert spans["prep.layout"]["start_ns"] >= spans["prep.pack_laplacian"]["end_ns"]
    else:
        assert spans == {}


def test_a_span_holds_the_profiled_op_it_wraps():
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            torch.mm(a, a)
    (span,) = profiling.snapshot()["spans"]
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert ops and all(span["start_ns"] <= e.start_ns() <= span["end_ns"] for e in ops)


def test_torch_trace_writes_the_snapshot_beside_the_trace(tmp_path):
    with profiling.torch_trace(str(tmp_path)):
        with profiling.span("block"):
            profiling.count("n", 4)
    assert profiling.span("x") is profiling.span("y")  # off again
    (trace,) = tmp_path.glob("*.json")
    (spans,) = tmp_path.glob("*.spans.jsonl")
    assert spans.name == trace.name.replace(".json", ".spans.jsonl")
    lines = [json.loads(line) for line in spans.read_text().splitlines()]
    assert lines[0] == {"counts": {"n": 4}}
    assert [s["name"] for s in lines[1:]] == ["block"] and lines[1]["counts"] == {"n": 4}
