"""One run of one cell: set-up, the measured window, the end-to-end and
per-layer metrics, and the correctness check.

The loop named by the cell's traffic mix (``loops/<loop>.py``) provides
``setup(cell)``, ``window(cell, seconds) -> units of work``, ``e2e(cell,
units, seconds) -> {metric: value}`` and ``record(cell) -> [records]`` for
the reference; everything else is common.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
import zlib
from typing import Optional

import numpy as np
import torch

from . import manifest as mf
from .host import Beside
from .probes import Probes

# Top-level module names the program's process must never load.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "graphgp_tpu")


class Seeds:
    """Whole numbers in [0, 2^31) for each purpose, drawn from ``--seed``."""

    def __init__(self, seed: int):
        self.seed = int(seed) % (1 << 64)

    def draw(self, purpose: str, k: int = 0) -> int:
        seq = np.random.SeedSequence([self.seed, zlib.crc32(purpose.encode()), k])
        return int(seq.generate_state(1)[0] & 0x7FFFFFFF)

    def rng(self, purpose: str) -> np.random.Generator:
        return np.random.default_rng(self.draw(purpose))


class Cell:
    def __init__(self, workload: dict, config: dict, traffic: dict, seed: int, device: str,
                 traced: bool, root: str):
        self.workload, self.config, self.traffic = workload, config, traffic
        self.seeds = Seeds(seed)
        self.device = torch.device(device)
        self.probes = Probes(traced)
        self.root = root
        self.state: dict = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _profile(cell: Cell):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if cell.device.type == "cuda" else [ProfilerActivity.CPU]
    return profile(activities=acts)


def _per_layer(cell: Cell, manifest: dict, summary: Optional[dict], bench: str) -> dict:
    out = {}
    ctx = {"probes": cell.probes, "trace": summary, "state": cell.state}
    for m in mf.metrics_for(manifest, "per_layer", cell.workload["name"]):
        value = mf.metric_reader(m["name"], bench).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(cell: Cell, records: list, limits: dict, control: bool = False) -> tuple:
    """(checks, readings): each number the cell's limits name, the worst over
    the records, beside its limit; and the numbers no limit names, with what
    the program reports of its solves, for the record."""
    from gpbench.reference import checks

    worst: dict = {}
    for rec in records:
        got = checks.numbers(rec, cell.device, control=control)
        if not control:
            got.update(checks.diagnostics(rec))
        for name, value in got.items():
            worst[name] = max(worst.get(name, 0.0), value)
    judged = {name: {"value": worst.get(name), "limit": limits[name]} for name in sorted(limits)}
    readings = {name: worst[name] for name in sorted(set(worst) - set(limits))}
    return judged, readings


def passed(result: dict) -> bool:
    return all(c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
               for c in result.values())


def run(workload_name: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
        root: str = mf.ROOT, bench: str = mf.HERE, t_start: Optional[float] = None,
        manifest: Optional[dict] = None, config: Optional[dict] = None,
        traffic: Optional[dict] = None, limits: Optional[dict] = None,
        control: bool = False):
    """Run the cell; returns the result line as a dict, ``checks`` last.
    Raises where the run cannot give a result. ``control`` adds the
    bfloat16 reference's readings in the program's place (``control.py``;
    the benchmark's own runs never read them)."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = manifest or mf.load(root)
    w = mf.workload(manifest, workload_name)
    config = config or mf.config(w["config"], bench)
    traffic = traffic or mf.traffic(w["traffic"], bench)
    limits = limits if limits is not None else mf.limits(workload_name, bench)
    loop = mf.loop(traffic["loop"], bench)
    cell = Cell(w, config, traffic, seed, device, traced, root)

    if cell.device.type == "cuda":
        torch.zeros(1, device=cell.device)
    t_setup = time.perf_counter()
    loop.setup(cell)
    cell.sync()
    setup_s = time.perf_counter() - t_start
    phases = ", ".join(f"{k} {sum(v):.3f}" for k, v in cell.probes.span_seconds.items())
    print(f"setup: {setup_s:.3f} s, {t_setup - t_start:.3f} s to import and reach the card; "
          f"{phases}", file=sys.stderr)

    cell.probes.span_seconds.clear()
    cell.probes.span_ns.clear()
    cell.probes.counters.clear()
    prof = _profile(cell) if traced else contextlib.nullcontext()
    with Beside() as beside:
        t0 = time.perf_counter()
        with prof, cell.probes.span("window"):
            units = loop.window(cell, seconds)
            cell.sync()
        window_s = time.perf_counter() - t0
    print(beside.describe(), file=sys.stderr)

    metrics = {}
    if not traced:
        values = dict(loop.e2e(cell, units, window_s), setup_s=setup_s)
        for m in mf.metrics_for(manifest, "end_to_end", workload_name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
           "kind": torch.cuda.get_device_name(cell.device) if cell.device.type == "cuda"
           else "cpu",
           "count": int(w["chips"]),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(cell.device))
           if cell.device.type == "cuda" else 0}
    breakdown = None
    if traced:
        from torch.autograd import DeviceType

        from . import trace

        summary = trace.reduce(prof.profiler.kineto_results.events(), DeviceType.CUDA,
                               cell.probes.span_ns)
        del prof
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
        print(f"trace: {summary['events']} device events, {summary['launches']} launches, "
              f"{summary['unmatched']} device events without a launch in the trace; device "
              f"seconds by span {summary['device_s_by_span']}", file=sys.stderr)
        metrics = _per_layer(cell, manifest, summary, bench)

    records = loop.record(cell)
    cell.probes.restore()
    cell.state.clear()
    cell.sync()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    checks, readings = judge(cell, records, limits)
    for name, value in readings.items():
        print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    if control:
        controls, control_readings = judge(cell, records, limits, control=True)
    result = {"correct": passed(checks), "attempted": int(units),
              "failed": sum(1 for c in checks.values()
                            if c["value"] is None or c["limit"] is None
                            or c["value"] > c["limit"]),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["control"] = dict(controls, **{k: {"value": v, "limit": None}
                                              for k, v in control_readings.items()})
        result["readings"] = readings
    result["checks"] = checks
    return result


def check_environment(chips: int) -> Optional[str]:
    """Why the run cannot be made on this machine, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards; {torch.cuda.device_count()} present"
    return None


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".gpbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
