"""The benchmark's own instrumentation, put around calls into the program's
layers: host spans, byte counters at the operator's call sites, and the
captures that the correctness check reads once the window has closed.

Nothing here changes what the program computes. Where the program would
draw its own random numbers inside a call (the Thompson draw's ε₁ and ε₂),
the wrapper draws them from the program's generator, in the program's
order and shapes, and hands them in through the call's public arguments.

A span is timed by the host clock. In a traced run its start and end are
also kept in Unix nanoseconds, the clock of the profiler's timestamps, so
the trace's reduction places it beside the device activity it launched.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch


class Probes:
    def __init__(self, traced: bool):
        self.traced = traced
        self.span_seconds: Dict[str, List[float]] = defaultdict(list)
        self.span_ns: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self.counters: Dict[str, float] = defaultdict(float)
        self.captures: Dict[str, object] = {}
        self.flags: Dict[str, bool] = defaultdict(bool)
        self._undo: List[Callable[[], None]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0, ns0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.span_seconds[name].append(time.perf_counter() - t0)
            if self.traced:
                self.span_ns[name].append((ns0, time.time_ns()))

    def patch(self, owner, attr: str, make: Callable) -> None:
        """Replace ``owner.attr`` by ``make(original)`` until :meth:`restore`.
        Raises where the program has no such attribute: a probe that finds
        nothing to wrap would leave its metric or its check silently empty."""
        if isinstance(owner, type):
            original = owner.__dict__.get(attr)
        else:
            original = getattr(owner, attr, None)
        if original is None:
            raise AttributeError(f"the program has no {getattr(owner, '__name__', owner)}."
                                 f"{attr} for the benchmark's probe")
        setattr(owner, attr, make(original))
        self._undo.append(lambda: setattr(owner, attr, original))

    def spanned(self, owner, attr: str, name: str, count: Callable = None) -> None:
        """Wrap ``owner.attr`` in the span ``name``; ``count(*args)`` adds to
        the counters before each call."""

        def make(fn):
            def wrapper(*args, **kwargs):
                if count is not None:
                    count(*args, **kwargs)
                with self.span(name):
                    return fn(*args, **kwargs)
            return wrapper

        self.patch(owner, attr, make)

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()


def detach(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in params.items()}
