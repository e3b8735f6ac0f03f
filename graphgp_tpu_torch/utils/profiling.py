"""Observability: the program's span and counter recorder, a throughput
helper and the Chrome-trace exporter.

The recorder keeps named spans (start, end, parent) and counters in memory,
for a reader that places them beside a profiler's device activity:

    from graphgp_tpu_torch.utils import profiling

    profiling.reset(); profiling.enable()
    ...                                   # spans and counts are kept
    snap = profiling.snapshot(); profiling.disable()

Spans nest on a per-thread stack. A count lands in the innermost open span
and, when that span closes, in its parent, so each span's ``counts`` hold
its children's. A span opened with ``lend=True`` also takes in the spans and
counts of any thread that has none of its own open while it is: autograd
runs a CUDA backward pass on a thread of its own while the caller waits.
Timestamps are ``time.time_ns()``, the clock of the ``torch.profiler``
event timestamps, so spans and a device trace share one timeline. The
recorder is off by default: :func:`span` then returns one shared no-op
context after a single flag test, reads no clock, and :func:`count`
returns. It never emits profiler events, never synchronizes
and never reads a tensor.

Counterpart of ``graphgp_tpu/utils/profiling.py``; :func:`torch_trace` is
the counterpart of its ``jax_trace``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

# the recorder's clock: Unix nanoseconds, as the profiler's timestamps
_clock = time.time_ns

_on = False
_local = threading.local()
_lock = threading.Lock()        # guards what threads share below, while on
_spans: List[tuple] = []        # (id, parent id, name, start_ns, end_ns, counts)
_totals: Dict[str, int] = defaultdict(int)
_next_id = itertools.count()
_lent: List["Span"] = []        # open spans that other threads nest in
_tallies = 0                    # threads inside tally() now


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Forget every closed span and count. Spans open now still close into
    the new record; their parents opened before are left out of it."""
    with _lock:
        _spans.clear()
        _totals.clear()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _top() -> Optional["Span"]:
    """The innermost open span of this thread, else the innermost lent one."""
    stack = _stack()
    if stack:
        return stack[-1]
    return _lent[-1] if _lent else None


def _add(span: Optional["Span"], counts) -> None:
    """Add ``(name, n)`` pairs to ``span``'s counts; hold the lock."""
    if span is not None:
        if span.counts is None:
            span.counts = defaultdict(int)
        for k, n in counts:
            span.counts[k] += n


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One span. ``seconds`` is its length once closed (:func:`timed`)."""

    __slots__ = ("name", "start_ns", "end_ns", "counts", "_id", "_parent", "_kept", "_lend")

    def __init__(self, name: str, kept: bool, lend: bool = False):
        self.name = name
        self.counts: Optional[Dict[str, int]] = None
        self._kept = kept
        self._lend = lend

    def __enter__(self):
        self.start_ns = _clock()
        if self._kept:
            with _lock:
                top = _top()
                self._parent = top._id if top is not None else None
                self._id = next(_next_id)
                _stack().append(self)
                if self._lend:
                    _lent.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock()
        if self._kept:
            with _lock:
                stack = _stack()
                if stack and stack[-1] is self:
                    stack.pop()
                if self._lend and self in _lent:
                    _lent.remove(self)
                counts = dict(self.counts) if self.counts else {}
                _add(_top(), counts.items())
                _spans.append((self._id, self._parent, self.name, self.start_ns,
                               self.end_ns, counts))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _tally() -> Optional[Dict[str, int]]:
    return getattr(_local, "tally", None) if _tallies else None


def span(name: str, lend: bool = False):
    """A span named ``name`` around a block, kept while the recorder is on;
    with ``lend``, threads with no open span of their own nest in it."""
    if not _on or _tally() is not None:
        return _OFF
    return Span(name, True, lend)


def timed(name: str, needed: bool = True):
    """A span that reads the clock whenever ``needed``, for a caller that
    keeps its own time of the block (``.seconds``), and is kept while the
    recorder is on: the caller's time and the span are the same two
    readings. Not ``needed`` it is :func:`span`."""
    if not (_on or needed):
        return _OFF
    return Span(name, _on)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host number, never a tensor) to the counter ``name``, in
    the innermost open span of this thread (or the lent one); inside
    :func:`tally`, to its dict."""
    into = _tally()
    if into is not None:
        into[name] = into.get(name, 0) + n
        return
    if not _on:
        return
    with _lock:
        _totals[name] += n
        _add(_top(), ((name, n),))


@contextlib.contextmanager
def tally():
    """Counts made on this thread inside the block go to the dict it yields,
    whether the recorder is on or off, and not into the record; the thread's
    spans there are not kept. For work captured once and replayed (a CUDA
    graph): add the dict's counts with :func:`count` at every replay."""
    global _tallies
    outer = getattr(_local, "tally", None)
    counts: Dict[str, int] = {}
    _local.tally = counts
    with _lock:
        _tallies += 1
    try:
        yield counts
    finally:
        _local.tally = outer
        with _lock:
            _tallies -= 1


def host_sync():
    """A ``sync`` span and one ``host.syncs`` count around a read that makes
    the host wait for the device (a flag, ``.cpu()``, ``int(tensor)``, a
    synchronize the code already makes). It adds no wait of its own."""
    if not _on:
        return _OFF
    count("host.syncs")
    return Span("sync", True)


def snapshot() -> dict:
    """``{"spans": [{"id", "parent", "name", "start_ns", "end_ns", "counts"}],
    "counts": {name: total}}``: the closed spans in order of their start
    (each span's counts hold its children's) and every counter's total."""
    with _lock:
        spans = sorted(_spans, key=lambda s: (s[3], s[0]))
        totals = dict(_totals)
    return {"spans": [{"id": i, "parent": p, "name": name, "start_ns": a, "end_ns": b,
                       "counts": c} for i, p, name, a, b, c in spans],
            "counts": totals}


def walks_per_second(num_nodes: int, walks_per_node: int, seconds: float) -> float:
    return num_nodes * walks_per_node / max(seconds, 1e-12)


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace around a block and write it to
    ``log_dir`` as one Chrome trace file (``chrome://tracing``, Perfetto):
    host ops, and the card's kernels when a card is present. The recorder
    is reset and on for the block; its snapshot is written beside the
    trace as JSON lines under the same name, ``.spans.jsonl`` for
    ``.json``: the counters' totals first, then one span a line."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    reset()
    enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        snap = snapshot()
        if not was_on:
            disable()
    base = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}")
    prof.export_chrome_trace(base + ".json")
    with open(base + ".spans.jsonl", "w") as fh:
        fh.write(json.dumps({"counts": snap["counts"]}) + "\n")
        for s in snap["spans"]:
            fh.write(json.dumps(s) + "\n")
