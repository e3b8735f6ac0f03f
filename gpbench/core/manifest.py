"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json`` (whose ``loop`` names the generator that reads it,
``loops/<loop>.py``), a per-layer metric ``metrics/<metric>.py`` and a cell's
limits ``limits/<workload>.json``, all under the benchmark's folder. Adding
any of them adds a file and an entry; no file that is there changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(kind: str, name: str, bench: str = HERE) -> dict:
    with open(os.path.join(bench, kind, f"{name}.json")) as fh:
        return json.load(fh)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench: str = HERE) -> dict:
    return _json("configs", name, bench)


def traffic(name: str, bench: str = HERE) -> dict:
    return _json("traffic", name, bench)


def limits(workload_name: str, bench: str = HERE) -> Dict[str, float]:
    return _json("limits", workload_name, bench)


def _module(kind: str, name: str, bench: str):
    """``<bench>/<kind>/<name>.py`` loaded from its path (a metric's name may
    hold dots, and a copy of the folder finds its own files)."""
    path = os.path.join(bench, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"gpbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(name: str, bench: str = HERE):
    return _module("loops", name, bench)


def metric_reader(name: str, bench: str = HERE):
    return _module("metrics", name, bench)


def metrics_for(manifest: dict, kind: str, workload_name: str):
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or workload_name in m["workloads"]]
