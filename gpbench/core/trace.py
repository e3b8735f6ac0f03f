"""Reduction of a profiler trace to the device's busy time, device time by
the benchmark's spans, the top device operations and the longest idle gaps.

The profiler records device activity only (and the host's CUDA API calls
that CUPTI sees); the spans are the benchmark's own, in Unix nanoseconds,
the clock of the profiler's timestamps. The trace is read from the
profiler's raw results, without building its event tree: a window of the
flagship holds about a million device operations. A device operation
belongs to the span of a kind that was open when the host launched it,
matched through the launch's correlation id.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import numpy as np

# Spans that name what the host was doing during an idle gap.
HOST_SPANS = ("fit", "draw", "select", "walk_consolidate", "layout")
# Spans whose device time a per-layer metric reads.
PRODUCT_SPANS = ("k1", "ell")


def _is_launch(name: str) -> bool:
    return name.startswith("cuda") or name.startswith("cuLaunch")


def reduce(events: Iterable, device_type_cuda, spans: Dict[str, List[Tuple[int, int]]]) -> dict:
    """Busy and window seconds, device seconds by product span, the top
    device operations and the longest idle gaps named by the host span open
    at their middle. ``spans``: name -> [(start_ns, end_ns)], with one
    ``window``."""
    launches: Dict[int, int] = {}
    dev: List[Tuple[int, int, str, int]] = []
    for e in events:
        if e.device_type() == device_type_cuda:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.duration_ns(), e.name(), e.correlation_id()))
        elif _is_launch(e.name()):
            launches[e.correlation_id()] = e.start_ns()
    w0, w1 = spans["window"][0]
    window_s = (w1 - w0) * 1e-9
    dev = [d for d in dev if d[0] < w1 and d[0] + d[1] > w0]
    if not dev:
        return {"launches": len(launches), "window_s": window_s, "busy_s": 0.0,
                "device_s_by_span": {}, "device_ops": [], "idle_gaps": [], "events": 0,
                "unmatched": 0}

    starts = np.array([max(d[0], w0) for d in dev], dtype=np.int64)
    ends = np.array([min(d[0] + d[1], w1) for d in dev], dtype=np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    opens = np.ones(len(s), dtype=bool)
    opens[1:] = s[1:] > run_end[:-1]
    group = np.cumsum(opens) - 1
    m_start = s[opens]
    m_end = np.zeros(opens.sum(), dtype=np.int64)
    np.maximum.at(m_end, group, e)
    busy_s = float((m_end - m_start).sum()) * 1e-9

    gap_lo = np.concatenate([[w0], m_end])
    gap_hi = np.concatenate([m_start, [w1]])
    gaps = gap_hi - gap_lo
    top = np.argsort(-gaps)[:10]
    host = sorted((a, b, n) for n in HOST_SPANS for a, b in spans.get(n, []))
    host_starts = [h[0] for h in host]

    def host_span_at(t):
        i = bisect.bisect_right(host_starts, t)
        for a, b, n in reversed(host[max(0, i - 64):i]):
            if a <= t < b:
                return n
        return "window"

    # a gap is named by the span the host was in at its middle: the device
    # idles while the host works there, before the launch that ends the gap
    idle_gaps = [[host_span_at(int(gap_lo[i] + gaps[i] // 2)), float(gaps[i]) * 1e-9]
                 for i in top if gaps[i] > 0]

    by_name: Dict[str, float] = defaultdict(float)
    for d in dev:
        by_name[d[2]] += d[1] * 1e-9
    device_ops = [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]

    by_span: Dict[str, float] = defaultdict(float)
    for name in PRODUCT_SPANS:
        ranges = sorted(spans.get(name, []))
        if not ranges:
            continue
        lo = [r[0] for r in ranges]
        for d in dev:
            t = launches.get(d[3])
            if t is None:
                continue
            i = bisect.bisect_right(lo, t) - 1
            if i >= 0 and t < ranges[i][1]:
                by_span[name] += d[1] * 1e-9
    unmatched = sum(1 for d in dev if d[3] not in launches)
    return {"launches": len(launches), "window_s": window_s, "busy_s": busy_s,
            "device_s_by_span": dict(by_span), "device_ops": device_ops,
            "idle_gaps": idle_gaps, "events": len(dev), "unmatched": unmatched}
