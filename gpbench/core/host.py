"""What the host gave a run: one ``host:`` line on standard error.

The BO windows are paced by the host (a blocking read every CG iteration),
so a run is as fast as the host's CPU is while the window lasts. Beside the
window, a process of its own times a fixed loop of Python adds every half
second; slow samples there mean a slow host, not a slow change. The
window's CPU seconds over its wall seconds say whether the run's process
was kept off a CPU (well under 1) or ran on a slow one (near 1).
"""
from __future__ import annotations

import glob
import os
import resource
import statistics
import subprocess
import sys
import time
from typing import List, Optional

LOOP_ADDS = 100_000
_SAMPLER = ("import time\n"
            "while True:\n"
            "    t = time.perf_counter()\n"
            "    s = 0\n"
            f"    for i in range({LOOP_ADDS}):\n"
            "        s += i\n"
            "    print((time.perf_counter() - t) * 1e3, flush=True)\n"
            "    time.sleep(0.5)\n")


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


class Beside:
    """``with Beside() as host:`` around the window: starts the sampler and
    waits for its first sample, and on leaving stops it and waits for it to
    end; ``host.describe()`` is then the ``host:`` line."""

    def __enter__(self) -> "Beside":
        self.proc = subprocess.Popen([sys.executable, "-c", _SAMPLER], stdout=subprocess.PIPE,
                                     text=True)
        first = self.proc.stdout.readline()
        self.before: Optional[float] = float(first) if first.strip() else None
        self.samples: List[float] = []
        self.cpu_s, self.wall_s = _cpu_s(), time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.wall_s = time.perf_counter() - self.wall_s
        self.cpu_s = _cpu_s() - self.cpu_s
        self.proc.terminate()
        out, _ = self.proc.communicate()
        self.samples = [float(line) for line in out.split()]
        return False

    def describe(self) -> str:
        s = self.samples
        if len(s) >= 2:
            q1, med, q3 = statistics.quantiles(s, n=4)
            loop = f"median {med:.2f} ms over {len(s)} samples (quartiles {q1:.2f}, {q3:.2f})"
        else:
            loop = f"{len(s)} samples"
        before = "none" if self.before is None else f"{self.before:.2f} ms"
        nodes = len(glob.glob("/sys/devices/system/node/node[0-9]*"))
        return (f"host: window {self.wall_s:.2f} s wall, {self.cpu_s:.2f} s CPU "
                f"({self.cpu_s / max(self.wall_s, 1e-9):.3f} of the wall); {LOOP_ADDS} Python "
                f"adds in a process beside it: {before} before the window, {loop}; "
                f"{len(os.sched_getaffinity(0))} CPUs in the affinity mask, {nodes} NUMA nodes "
                f"visible")
