"""Run one cell of the benchmark of ``graphgp_tpu_torch`` once.

    python3 gpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``, each compared number beside its limit.
The same numbers end standard error. Exits non-zero, printing no result,
without a CUDA card (or with fewer than the cell asks for), without the
program, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from gpbench.core import cell, manifest

    cell.cache_dirs(ROOT)
    w = manifest.workload(manifest.load(ROOT), a.workload)
    why = cell.check_environment(int(w["chips"]))
    if why is not None:
        print(f"gpbench: {why}; no result", file=sys.stderr)
        return 2
    result = cell.run(a.workload, a.seed, a.seconds, bool(a.trace), device="cuda",
                      root=ROOT, t_start=T_START)
    loaded = cell.forbidden_loaded()
    if loaded:
        print(f"gpbench: the process loaded {loaded}; no result", file=sys.stderr)
        return 3
    print(f"card: {cell.power_limit()} (H100 SXM peaks: 3.35 TB/s HBM, 67 TFLOP/s fp32)",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
