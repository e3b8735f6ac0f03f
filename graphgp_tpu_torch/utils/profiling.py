"""Profiling and observability: phase timers, throughput counters, trace
capture and device memory readers.

Counterpart of ``graphgp_tpu/utils/profiling.py``; :func:`torch_trace` is
the counterpart of its ``jax_trace``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulates named wall-clock phases; prints a one-line summary. A phase
    that ends on a CUDA ``device`` is closed by a synchronize, so its time
    includes the device work it queued."""

    def __init__(self, device=None):
        self.phases: Dict[str, float] = {}
        self.device = None if device is None else torch.device(device)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - t0)

    def summary(self) -> str:
        return " | ".join(f"{k}={v:.2f}s" for k, v in self.phases.items())


def walks_per_second(num_nodes: int, walks_per_node: int, seconds: float) -> float:
    return num_nodes * walks_per_node / max(seconds, 1e-12)


def memory_mb() -> Optional[float]:
    """Resident set size of this process in MB, or None without psutil."""
    try:
        import psutil
    except ImportError:
        return None
    return psutil.Process().memory_info().rss / 1e6


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace around a block and write it to
    ``log_dir`` as one Chrome trace file (``chrome://tracing``, Perfetto):
    host ops, and the card's kernels when a card is present."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_memory_stats() -> Dict[str, Optional[Dict[str, float]]]:
    """Per-card allocated, peak-allocated and reserved MB from ``torch.cuda``;
    an empty dict without a card."""
    out: Dict[str, Optional[Dict[str, float]]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "allocated_mb": torch.cuda.memory_allocated(i) / 1e6,
            "peak_allocated_mb": torch.cuda.max_memory_allocated(i) / 1e6,
            "reserved_mb": torch.cuda.memory_reserved(i) / 1e6,
        }
    return out
