"""The scaling experiment end to end on the CPU at a tiny size, as
tests/test_workloads.py drives the JAX package's, and its helpers."""
import csv

import numpy as np
import pytest
import torch

from graphgp_tpu_torch.cli import scaling
from graphgp_tpu_torch.utils import profiling, walks_per_second


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("scaling")
    records = scaling.main([
        "--sizes", "64", "--walks-per-node", "20", "--train-epochs", "5", "--device", "cpu",
        "--results-dir", str(root / "res"), "--cache-dir", str(root / "cache"),
    ])
    return records, root


def test_cli_scaling_small(run):
    records, root = run
    assert {r["phase"] for r in records} == {"rw", "iterative_gp", "exact_gp"}
    assert (root / "res" / "scaling.csv").exists()
    with open(root / "res" / "scaling.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == len(records) == 3
    assert (root / "res" / "scaling_config.json").exists()
    # the step-matrix cache was written and is shared by both GP arms
    assert any(p.name.endswith(".stencil.npz") for p in (root / "cache").iterdir())


def test_cli_scaling_records_hold_the_reference_columns(run):
    records, _ = run
    by_phase = {r["phase"]: r for r in records}
    rw = by_phase["rw"]
    assert rw["n_nodes"] == 64 and rw["walks_per_node"] == 20
    assert rw["walks_per_s"] == pytest.approx(64 * 20 / rw["rw_seconds"])
    assert rw["nnz"] > 64 and rw["dense_rw_seconds"] > 0 and rw["rw_compile_seconds"] >= 0
    for phase in ("iterative_gp", "exact_gp"):
        rec = by_phase[phase]
        for key in ("train_seconds", "train_compile_seconds", "predict_seconds",
                    "predict_compile_seconds", "rmse", "final_loss"):
            assert np.isfinite(rec[key]), (phase, key)
        assert rec["rmse"] < 1.5  # the field's standard deviation is about 0.8


def test_cli_scaling_phase_flags(tmp_path):
    records = scaling.main([
        "--sizes", "32", "64", "--walks-per-node", "10", "--rw-only", "--dense-rw-max", "32",
        "--device", "cpu", "--results-dir", str(tmp_path), "--cache-dir", str(tmp_path / "c"),
    ])
    assert [r["phase"] for r in records] == ["rw", "rw"]
    assert "dense_rw_seconds" in records[0] and "dense_rw_seconds" not in records[1]


def test_cli_scaling_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="--device cpu"):
        scaling.main(["--sizes", "16", "--rw-only", "--results-dir", str(tmp_path)])


def test_fit_exponents_need_three_large_sizes():
    recs = [{"phase": "rw", "n_nodes": n, "rw_seconds": 1e-6 * n ** 1.5}
            for n in (1024, 4096, 16384, 65536)]
    out = scaling.fit_exponents(recs)
    assert len(out) == 1 and out[0]["n_points"] == 3 and out[0]["n_min"] == 4096
    assert out[0]["exponent"] == pytest.approx(1.5, abs=1e-6)
    assert scaling.fit_exponents(recs[:3]) == []


def test_profiling_helpers():
    assert walks_per_second(10, 5, 2.0) == 25.0
    assert walks_per_second(10, 5, 0.0) > 0
    profiling.reset()
    profiling.enable()
    try:
        with profiling.timed("walk") as phase:
            profiling.count("walks", 50)
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    (span,) = snap["spans"]
    assert span["name"] == "walk" and span["counts"] == {"walks": 50}
    assert phase.seconds == (span["end_ns"] - span["start_ns"]) * 1e-9 >= 0
    with profiling.timed("walk") as phase:  # off: timed, kept nowhere
        pass
    assert phase.seconds >= 0 and profiling.snapshot()["spans"] == []
