"""The program's spans beside the trace (``core/spans.py``): on a hand-made
trace, device operations and idle gaps go to the innermost program span;
in tiny traced CPU runs with the recorder on over the window, the readers
of the solver, BO-algorithm and preprocessing layers find what they read,
and the program counts the CG iterations the benchmark's probes count."""
import pytest

from gpbench.core import manifest as mf
from gpbench.core import spans, trace
from gpbench.tests.test_gpbench_cells import run_tiny
from gpbench.tests.test_gpbench_trace import CPU, CUDA, Ev


def _span(i, parent, name, a, b, **counts):
    return {"id": i, "parent": parent, "name": name, "start_ns": a, "end_ns": b,
            "counts": counts}


SNAPSHOT = {"spans": [
    _span(0, None, "gp.fit", 100, 700, **{"cg.iterations": 4, "host.syncs": 5}),
    _span(1, 0, "gp.step", 110, 690, **{"cg.iterations": 4, "host.syncs": 5}),
    _span(2, 1, "cg", 200, 500, **{"cg.iterations": 4, "host.syncs": 5}),
    _span(3, 2, "sync", 300, 320),
    _span(4, None, "bo.select", 720, 850),
    _span(5, 4, "bo.pick", 750, 800),
], "counts": {"cg.iterations": 4, "host.syncs": 5}}


class Probes:
    def __init__(self, snapshot=None):
        self.captures = {} if snapshot is None else {"program": snapshot}


def test_reduce_program_spans_on_a_hand_made_trace():
    events = [
        Ev(CPU, "cudaLaunchKernel", 150, 5, 1),   # gp.step
        Ev(CPU, "cudaLaunchKernel", 250, 5, 2),   # cg
        Ev(CPU, "cudaLaunchKernel", 318, 1, 5),   # the sync inside cg
        Ev(CPU, "cudaLaunchKernel", 550, 5, 3),   # gp.step, after cg closed
        Ev(CUDA, "a", 160, 110, 1),
        Ev(CUDA, "b", 270, 30, 2),
        Ev(CUDA, "c", 325, 5, 5),
        Ev(CUDA, "d", 600, 50, 3),
        Ev(CUDA, "e", 900, 50, 4),                # no launch in the trace
        Ev(CUDA, "annotation", 0, 1000, 6, annotation=True),
    ]
    t = spans.reduce(events, CUDA, SNAPSHOT, (0, 1000))
    assert t["ops"] == 5 and t["unmatched"] == 1
    assert t["ops_by_span"] == {"gp.fit": 4, "gp.step": 4, "cg": 2, "sync": 1}
    assert t["device_s_by_span"]["gp.fit"] == pytest.approx(195e-9)
    assert t["device_s_by_span"]["cg"] == pytest.approx(35e-9)
    # busy 160..300, 325..330, 600..650, 900..950; every gap by its middle
    assert t["idle_s"] == pytest.approx(755e-9)
    assert t["idle_s_by_path"] == {
        "": pytest.approx(210e-9),                          # 0..160, 950..1000
        "gp.fit/gp.step/cg/sync": pytest.approx(25e-9),     # 300..325
        "gp.fit/gp.step/cg": pytest.approx(270e-9),         # 330..600
        "bo.select/bo.pick": pytest.approx(250e-9),         # 650..900
    }
    assert [g[0] for g in t["longest_gaps"]] == ["gp.fit/gp.step/cg", "bo.select/bo.pick", "",
                                                 "", "gp.fit/gp.step/cg/sync"]
    ctx = {"probes": Probes(SNAPSHOT), "program": t}
    assert spans.cg_iters_per_fit(ctx) == 4
    assert spans.syncs_per_fit(ctx) == 5
    assert spans.fit_launches(ctx) == 4
    assert spans.solver_idle_s(ctx) == pytest.approx(295e-9)
    assert spans.pick_s(ctx) == pytest.approx(50e-9)
    assert spans.pack_s(ctx) is None
    assert "gp.fit/gp.step/cg" in spans.describe(t)


def test_the_readers_find_nothing_without_the_recorder():
    assert spans.reduce([], CUDA, None, (0, 1)) is None
    ctx = {"probes": Probes(), "program": None}
    for read in (spans.cg_iters_per_fit, spans.syncs_per_fit, spans.fit_launches,
                 spans.solver_idle_s, spans.pick_s, spans.pack_s):
        assert read(ctx) is None
    empty = spans.reduce([], CUDA, SNAPSHOT, (0, 1))
    assert spans.fit_launches({"probes": Probes(SNAPSHOT), "program": empty}) is None


def _recorded_run(workload, tmp_path, monkeypatch):
    """A tiny traced run with the program's recorder on over the window and
    the profiler's events kept, as a traced run would wire them."""
    seen = {}
    load_loop, reduce_trace = mf.loop, trace.reduce

    def loop(name, bench=mf.HERE):
        mod = load_loop(name, bench)
        window = mod.window

        def recorded(cell, seconds):
            seen["cell"] = cell
            with spans.recording(cell.probes):
                return window(cell, seconds)

        mod.window = recorded
        return mod

    def reduce(events, device_type, span_ns):
        seen["events"] = list(events)
        seen["window"] = span_ns["window"][0]
        return reduce_trace(seen["events"], device_type, span_ns)

    monkeypatch.setattr(mf, "loop", loop)
    monkeypatch.setattr(trace, "reduce", reduce)
    r = run_tiny(workload, tmp_path, traced=True)
    assert r["correct"], r["checks"]
    probes = seen["cell"].probes
    from torch.autograd import DeviceType

    table = spans.reduce(seen["events"], DeviceType.CUDA, probes.captures.get("program"),
                         seen["window"])
    return {"probes": probes, "program": table}


@pytest.mark.parametrize("workload", ["grid_1m.bo_b100", "facebook.bo_b1"])
def test_tiny_traced_bo_runs_read_the_solver_spans(workload, tmp_path, monkeypatch):
    ctx = _recorded_run(workload, tmp_path, monkeypatch)
    snap = ctx["probes"].captures["program"]
    assert snap["counts"]["cg.iterations"] == ctx["probes"].counters["cg.iterations"]
    assert snap["counts"]["cg.solves"] == ctx["probes"].counters["cg.solves"]
    assert spans.cg_iters_per_fit(ctx) > 0
    assert spans.syncs_per_fit(ctx) > spans.cg_iters_per_fit(ctx)
    assert spans.pick_s(ctx) > 0
    # the CPU has no device trace: its readers find nothing
    assert spans.fit_launches(ctx) is None and spans.solver_idle_s(ctx) is None
    assert ctx["program"]["ops"] == 0


def test_a_tiny_traced_build_run_reads_the_pack(tmp_path, monkeypatch):
    ctx = _recorded_run("grid_1m.features", tmp_path, monkeypatch)
    assert spans.pack_s(ctx) > 0
    assert spans.cg_iters_per_fit(ctx) is None
