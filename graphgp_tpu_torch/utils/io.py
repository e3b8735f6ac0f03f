"""Results I/O: CSV results with a timestamped copy, a config snapshot, and a
grouped mean/std summary.

Counterpart of ``save_results`` / ``print_summary`` / ``compute_fro`` in
``graphgp_tpu/utils/io.py``, on the standard library's csv module (the GPU
machine has no pandas).
"""
from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def save_results(
    records: List[Dict], results_dir: str, name: str, config: Optional[Dict] = None
) -> str:
    """Write records to ``<name>.csv`` plus a timestamped copy and a config
    snapshot. Returns the stable CSV path."""
    os.makedirs(results_dir, exist_ok=True)
    fields: List[str] = []
    for rec in records:
        fields.extend(k for k in rec if k not in fields)
    stable = os.path.join(results_dir, f"{name}.csv")
    stamp = time.strftime("%Y%m%d_%H%M%S")
    for path in (stable, os.path.join(results_dir, f"{name}_{stamp}.csv")):
        with open(path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=fields)
            writer.writeheader()
            writer.writerows(records)
    if config is not None:
        with open(os.path.join(results_dir, f"{name}_config.json"), "w") as fh:
            json.dump(config, fh, indent=2, default=str)
    return stable


def summarize_results(
    records: List[Dict], group_keys: Sequence[str], value_keys: Sequence[str]
) -> List[Dict]:
    """Per-group mean and sample std (ddof 1, as pandas) of each value key."""
    groups: Dict[tuple, List[Dict]] = {}
    for rec in records:
        groups.setdefault(tuple(rec.get(k) for k in group_keys), []).append(rec)
    rows = []
    for key, recs in groups.items():
        row = dict(zip(group_keys, key))
        for vk in value_keys:
            vals = np.asarray([r[vk] for r in recs if vk in r], dtype=np.float64)
            if vals.size:
                row[f"{vk}_mean"] = float(vals.mean())
                row[f"{vk}_std"] = float(vals.std(ddof=1)) if vals.size > 1 else float("nan")
        rows.append(row)
    return rows


def print_summary(records: List[Dict], group_keys: Sequence[str], value_keys: Sequence[str]):
    rows = summarize_results(records, group_keys, value_keys)
    for row in rows:
        print("  ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
    return rows


def compute_fro(k_est: np.ndarray, k_ref: np.ndarray) -> float:
    """Relative Frobenius distance between kernel matrices."""
    k_est = np.asarray(k_est)
    k_ref = np.asarray(k_ref)
    return float(np.linalg.norm(k_est - k_ref) / np.linalg.norm(k_ref))
