"""Readings that set each limit of a cell: the program's numbers over many
seeds, the control's (the plain reference computed in bfloat16 put in the
program's place) on the same seeds and state, and the program's under a
planted fault.

    python3 gpbench/control.py --workload <name> --seeds 11 12 13 ... \
        [--seconds 1] [--bo-seeds 100 110 ...] [--fault <name>]

Each seed is one run of the cell in this process (set-up, a window of at
least one whole unit of work, the check); one JSON line per seed with the
program's compared numbers (``checks``), the numbers no limit names and
what the program reports of its solves (``readings``), and the control's
(``control``). ``--bo-seeds`` gives each seed of a BO mix one BO run, the
i-th seed the i-th BO seed of the list (cycled): the check reads the last
run, so one suffices, and a BO seed given twice shows whether two runs of
the same work do the same work.
``--fault`` plants one of ``core/faults.py``'s faults for every seed. A limit
lies above every program reading and below the control's or a fault's
(PERF.md gives the readings each limit was set from). The benchmark's own
runs never run the control.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--bo-seeds", type=int, nargs="+", default=None)
    p.add_argument("--fault", default=None)
    a = p.parse_args(argv)

    from gpbench.core import cell, faults
    from gpbench.core import manifest as mf

    cell.cache_dirs(ROOT)
    w = mf.workload(mf.load(ROOT), a.workload)
    restore = faults.plant(a.fault) if a.fault else None
    try:
        for i, seed in enumerate(a.seeds):
            traffic = mf.traffic(w["traffic"])
            if a.bo_seeds:
                traffic["bo_seeds"] = [a.bo_seeds[i % len(a.bo_seeds)]]
            r = cell.run(a.workload, seed, a.seconds, False, device="cuda", root=ROOT,
                         traffic=traffic, control=True)
            line = {"seed": seed, "fault": a.fault, "correct": r["correct"],
                    "metrics": r["metrics"],
                    "checks": {k: v["value"] for k, v in r["checks"].items()},
                    "readings": r["readings"],
                    "control": {k: v["value"] for k, v in r["control"].items()}}
            print(json.dumps(line), flush=True)
    finally:
        if restore is not None:
            restore()
    return 0


if __name__ == "__main__":
    sys.exit(main())
