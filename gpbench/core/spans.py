"""The program's own spans and counters (``graphgp_tpu_torch.utils.profiling``)
beside the profiler's device activity, and what the per-layer metrics of the
solver, GP, BO-algorithm and preprocessing layers read from them.

:func:`recording` turns the program's recorder on for a block and keeps its
snapshot in ``probes.captures["program"]``. :func:`reduce` places the
snapshot on the profiler's timeline (both are Unix nanoseconds): each device
operation belongs to the innermost program span open when the host launched
it (matched through the launch's correlation id, as ``trace.reduce`` does
for its product spans) and to every span around that one; each idle gap of
the window, all of them, is named by the innermost program span open at its
middle. The readers return None where there is nothing to read, as on a
program without the recorder.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .trace import _is_launch

# spans whose host loop a solver's idle time is charged to
SOLVER_SPANS = ("cg", "lanczos", "gram_cg")


@contextlib.contextmanager
def recording(probes):
    """The program's recorder, reset and on for the block; its snapshot goes
    to ``probes.captures["program"]``. Does nothing where the program has no
    recorder."""
    try:
        from graphgp_tpu_torch.utils import profiling
    except ImportError:
        profiling = None
    if not hasattr(profiling, "snapshot"):
        yield
        return
    profiling.reset()
    profiling.enable()
    try:
        yield
    finally:
        probes.captures["program"] = profiling.snapshot()
        profiling.disable()


def _paths(spans: List[dict]) -> Dict[int, Tuple[str, ...]]:
    """Span id -> names from the outermost span down to it."""
    out: Dict[int, Tuple[str, ...]] = {}
    for s in spans:  # in order of their start: a parent comes first
        out[s["id"]] = out.get(s["parent"], ()) + (s["name"],)
    return out


def _segments(spans: List[dict]) -> Tuple[np.ndarray, np.ndarray]:
    """The timeline cut where a span opens or closes: (starts, innermost span
    id from there on, -1 where none is open)."""
    starts: List[int] = []
    labels: List[int] = []
    stack: List[dict] = []
    for s in sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"], s["id"])):
        while stack and stack[-1]["end_ns"] <= s["start_ns"]:
            top = stack.pop()
            starts.append(top["end_ns"])
            labels.append(stack[-1]["id"] if stack else -1)
        starts.append(s["start_ns"])
        labels.append(s["id"])
        stack.append(s)
    while stack:
        top = stack.pop()
        starts.append(top["end_ns"])
        labels.append(stack[-1]["id"] if stack else -1)
    return np.asarray(starts, dtype=np.int64), np.asarray(labels, dtype=np.int64)


def _innermost(times: np.ndarray, starts: np.ndarray, labels: np.ndarray) -> np.ndarray:
    if not len(starts):
        return np.full(len(times), -1, dtype=np.int64)
    i = np.searchsorted(starts, times, side="right") - 1
    return np.where(i >= 0, labels[np.maximum(i, 0)], -1)


def reduce(events: Iterable, device_type_cuda, snapshot: Optional[dict],
           window: Tuple[int, int]) -> Optional[dict]:
    """Device operations, device seconds and idle seconds by program span,
    over the window ``(start_ns, end_ns)``:

    ``ops_by_span`` / ``device_s_by_span``: span name -> operations launched
    inside any span of that name (inclusive of the spans inside it) and
    their device seconds; ``idle_s_by_path``: "outer/…/innermost" -> idle
    seconds of the gaps whose middle falls there ("" outside every span);
    ``longest_gaps``: the ten longest as [path, seconds]; ``idle_s``,
    ``ops``, ``unmatched`` (device operations without a launch in the
    trace). None without a snapshot."""
    if not snapshot:
        return None
    spans = snapshot["spans"]
    w0, w1 = window
    launches: Dict[int, int] = {}
    dev: List[Tuple[int, int, int]] = []
    for e in events:
        if e.device_type() == device_type_cuda:
            if not e.is_user_annotation():
                start, dur = e.start_ns(), e.duration_ns()
                if start < w1 and start + dur > w0:
                    dev.append((start, dur, e.correlation_id()))
        elif _is_launch(e.name()):
            launches[e.correlation_id()] = e.start_ns()
    paths = _paths(spans)
    seg_starts, seg_labels = _segments(spans)
    out = {"ops": len(dev), "unmatched": 0, "ops_by_span": {}, "device_s_by_span": {},
           "idle_s": 0.0, "idle_s_by_path": {}, "longest_gaps": []}
    if not dev:
        return out

    launch_t = np.asarray([launches.get(c, -1) for _, _, c in dev], dtype=np.int64)
    matched = launch_t >= 0
    out["unmatched"] = int((~matched).sum())
    durs = np.asarray([d for _, d, _ in dev], dtype=np.int64)
    owner = _innermost(launch_t[matched], seg_starts, seg_labels)
    ops, secs = _by_name(owner, durs[matched] * 1e-9, paths)
    out["ops_by_span"] = {k: int(v) for k, v in ops.items()}
    out["device_s_by_span"] = secs

    starts = np.asarray([max(s, w0) for s, _, _ in dev], dtype=np.int64)
    ends = np.asarray([min(s + d, w1) for s, d, _ in dev], dtype=np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    opens = np.ones(len(s), dtype=bool)
    opens[1:] = s[1:] > run_end[:-1]
    m_start = s[opens]
    m_end = np.zeros(int(opens.sum()), dtype=np.int64)
    np.maximum.at(m_end, np.cumsum(opens) - 1, e)
    lo = np.concatenate([[w0], m_end])
    hi = np.concatenate([m_start, [w1]])
    keep = hi > lo
    lo, gaps = lo[keep], (hi - lo)[keep]
    where = _innermost(lo + gaps // 2, seg_starts, seg_labels)
    idle: Dict[str, float] = defaultdict(float)
    for label, total in _sum_by(where, gaps * 1e-9).items():
        idle["/".join(paths.get(label, ()))] += total
    out["idle_s"] = float(gaps.sum()) * 1e-9
    out["idle_s_by_path"] = dict(idle)
    top = np.argsort(-gaps, kind="stable")[:10]
    out["longest_gaps"] = [["/".join(paths.get(int(where[i]), ())), float(gaps[i]) * 1e-9]
                           for i in top]
    return out


def _sum_by(labels: np.ndarray, weights: np.ndarray) -> Dict[int, float]:
    uniq, inv = np.unique(labels, return_inverse=True)
    sums = np.bincount(inv, weights=weights, minlength=len(uniq))
    return {int(u): float(t) for u, t in zip(uniq, sums)}


def _by_name(owner: np.ndarray, secs: np.ndarray, paths) -> Tuple[dict, dict]:
    """Per span name, the operations and seconds whose innermost span has
    that name or lies inside a span of that name."""
    counts = _sum_by(owner, np.ones(len(owner)))
    seconds = _sum_by(owner, secs)
    ops: Dict[str, float] = defaultdict(float)
    dev_s: Dict[str, float] = defaultdict(float)
    for label, n in counts.items():
        for name in set(paths.get(label, ())):
            ops[name] += n
            dev_s[name] += seconds[label]
    return dict(ops), dict(dev_s)


def describe(table: Optional[dict]) -> str:
    """The reduction as lines for standard error."""
    if not table:
        return "program spans: none recorded"
    lines = [f"program spans: {table['ops']} device operations ({table['unmatched']} "
             f"without a launch), {table['idle_s']:.4f} s idle"]
    for name in sorted(table["ops_by_span"], key=lambda k: -table["ops_by_span"][k]):
        lines.append(f"  ops {name}: {table['ops_by_span'][name]}, "
                     f"{table['device_s_by_span'][name]:.4f} device s")
    for path, s in sorted(table["idle_s_by_path"].items(), key=lambda kv: -kv[1]):
        lines.append(f"  idle {path or '(no span)'}: {s:.4f} s")
    for path, s in table["longest_gaps"]:
        lines.append(f"  gap {path or '(no span)'}: {s:.6f} s")
    return "\n".join(lines)


# --- what the per-layer metrics read ----------------------------------------
# ``ctx`` is a per-layer metric's: ``ctx["probes"].captures["program"]`` holds
# the snapshot and ``ctx["program"]`` the reduction.


def _spans(ctx, name: str) -> List[dict]:
    snap = ctx["probes"].captures.get("program")
    return [s for s in snap["spans"] if s["name"] == name] if snap else []


def _per_fit(ctx, counter: str):
    fits = _spans(ctx, "gp.fit")
    if not fits:
        return None
    return sum(s["counts"].get(counter, 0) for s in fits) / len(fits)


def cg_iters_per_fit(ctx):
    """CG iterations counted inside the ``gp.fit`` spans, per fit."""
    return _per_fit(ctx, "cg.iterations")


def syncs_per_fit(ctx):
    """Host syncs counted inside the ``gp.fit`` spans, per fit."""
    return _per_fit(ctx, "host.syncs")


def fit_launches(ctx):
    """Device operations launched inside the ``gp.fit`` spans, per fit."""
    table, fits = ctx.get("program"), _spans(ctx, "gp.fit")
    if not table or not fits or not table["ops"]:
        return None
    return table["ops_by_span"].get("gp.fit", 0) / len(fits)


def solver_idle_s(ctx):
    """Idle seconds of the gaps whose innermost span is a solver's host loop
    (``cg``, ``lanczos``, ``gram_cg``) or a ``sync`` right inside one, during
    fits, per fit."""
    table, fits = ctx.get("program"), _spans(ctx, "gp.fit")
    if not table or not fits or not table["ops"]:
        return None
    total = 0.0
    for path, s in table["idle_s_by_path"].items():
        names = path.split("/")
        if "gp.fit" not in names:
            continue
        if names[-1] in SOLVER_SPANS or (names[-1] == "sync" and len(names) > 1
                                         and names[-2] in SOLVER_SPANS):
            total += s
    return total / len(fits)


def _seconds_per(ctx, name: str, per: str):
    spans, units = _spans(ctx, name), _spans(ctx, per)
    if not spans or not units:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) * 1e-9 / len(units)


def pick_s(ctx):
    """Host seconds in ``bo.pick`` (exclusion and top-k), per iteration."""
    return _seconds_per(ctx, "bo.pick", "bo.select")


def pack_s(ctx):
    """Seconds in ``prep.pack_laplacian`` (scipy pack and upload), per build."""
    return _seconds_per(ctx, "prep.pack_laplacian", "prep.build")
