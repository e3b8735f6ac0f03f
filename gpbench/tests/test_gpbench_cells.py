"""The harness driven end to end on the CPU at tiny sizes: the reference
agrees with the port, the result line has the contract's keys, planted
faults make ``correct`` false, a new configuration, mix and metric are found
as files, and nothing the harness loads is JAX or the JAX package."""
import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gpbench.core import cell, manifest as mf, peaks

ROOT = mf.ROOT
M = mf.load()
# The facebook graph's feature builds are no cell of BENCHMARK.json (PERF.md,
# Open questions); their mix, limits and fault stay, and the tests run them as
# the entry that would add the cell back.
FACEBOOK_FEATURES = {"name": "facebook.features", "config": "facebook", "traffic": "features",
                     "chips": 1, "why": "back-to-back GRF builds of the facebook graph"}


def _with_facebook_features(manifest):
    man = copy.deepcopy(manifest)
    if all(w["name"] != FACEBOOK_FEATURES["name"] for w in man["workloads"]):
        man["workloads"].append(FACEBOOK_FEATURES)
        for m in man["end_to_end"] + man["per_layer"]:
            if "grid_1m.features" in m.get("workloads", ()):
                m["workloads"].append(FACEBOOK_FEATURES["name"])
    return man


M_ALL = _with_facebook_features(M)
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _skewed_npz(directory):
    """A 300-node star-and-random graph in the dataset cache's npz layout,
    saved as ``facebook.npz``: skewed degrees, so the layout is ELL with
    the column-sorted transpose, as on the facebook graph."""
    rng = np.random.default_rng(0)
    n = 300
    u = np.concatenate([np.zeros(60, int), rng.integers(0, n, 600)])
    v = np.concatenate([np.arange(1, 61), rng.integers(0, n, 600)])
    keep = u != v
    a = sp.coo_matrix((np.ones(keep.sum() * 2), (np.r_[u[keep], v[keep]], np.r_[v[keep], u[keep]])),
                      shape=(n, n)).tocsr()
    a.data[:] = 1.0
    y = np.asarray(a.sum(axis=1)).ravel().astype(np.float32)
    np.savez(os.path.join(directory, "facebook.npz"), A_data=a.data, A_indices=a.indices,
             A_indptr=a.indptr, A_shape=np.asarray(a.shape), X=np.arange(n), y=y)


# (nodes, walks per node) of the generated graphs at a CPU test's size; the
# rgg's kernel has to stand out of the estimator's noise, or its
# log-determinant and that number's scale are near 0 and rounding reads large
TINY_GRAPHS = {"grid_1m": (400, 32), "rgg_1m": (4096, 64)}


def tiny(workload, tmp_path):
    """(config, traffic) of a cell cut to a CPU test's size."""
    w = mf.workload(M_ALL, workload)
    cfg, trf = mf.config(w["config"]), mf.traffic(w["traffic"])
    if w["config"] in TINY_GRAPHS:
        cfg["graph"]["n_nodes"], cfg["walks"]["walks_per_node"] = TINY_GRAPHS[w["config"]]
    else:
        _skewed_npz(tmp_path)
        cfg["graph"]["directory"] = str(tmp_path)
        cfg["walks"]["walks_per_node"] = 16
    # a refit inside three iterations, as every run at the cells' size has
    cfg["bo"].update(iterations=3, train_epochs=3, gp_retrain_interval=2)
    if "batch_size" in trf:
        trf["batch_size"] = min(trf["batch_size"], 5)
        trf["bo_seeds"] = trf["bo_seeds"][:2]
    return cfg, trf


def run_tiny(workload, tmp_path, seed=2147483659, traced=False, initial_points=None, **kw):
    cfg, trf = tiny(workload, tmp_path)
    if initial_points:
        cfg["bo"]["initial_points"] = initial_points
    return cell.run(workload, seed, 0.5, traced, device="cpu", config=cfg, traffic=trf,
                    manifest=M_ALL, **kw)


CELLS = [w["name"] for w in M_ALL["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_is_correct_against_the_reference(workload, tmp_path):
    r = run_tiny(workload, tmp_path)
    assert list(r) == KEYS
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(mf.limits(workload))
    assert set(r["metrics"]) == {m["name"] for m in mf.metrics_for(M_ALL, "end_to_end", workload)}
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("workload", ["grid_1m.bo_b100", "grid_1m.features"])
def test_a_traced_run_reports_its_layers_and_a_breakdown(workload, tmp_path):
    r = run_tiny(workload, tmp_path, traced=True)
    assert list(r) == KEYS[:5] + ["breakdown", "checks"]
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                "window_s"}
    names = {m["name"] for m in mf.metrics_for(M, "per_layer", workload)}
    assert set(r["metrics"]) <= names
    host = {"fit_s", "draw_s", "select_host_s", "walk_consolidate_s", "layout_s"}
    assert names & host <= set(r["metrics"])


def test_the_control_fails_and_the_program_passes(tmp_path):
    r = run_tiny("grid_1m.bo_b100", tmp_path, control=True)
    assert r["correct"]
    assert not cell.passed({k: dict(r["control"][k], limit=v["limit"])
                            for k, v in r["checks"].items()})


# --- planted faults -----------------------------------------------------------


@pytest.mark.parametrize("workload,fault", [
    ("grid_1m.bo_b100", "state_unchanged"),
    ("grid_1m.bo_b100", "half_batch"),
    ("grid_1m.bo_b100", "answer_altered"),
    ("grid_1m.bo_b100", "params_unchanged"),
    ("grid_1m.bo_b100", "fit_half_observations"),
    ("grid_1m.bo_b100", "dw_zero"),
    ("grid_1m.bo_b100", "cg_loose"),
    ("facebook.bo_b1", "answer_altered"),
    ("facebook.bo_b1", "params_unchanged"),
    ("facebook.bo_b1", "fit_half_observations"),
    ("facebook.bo_b1", "dw_zero"),
    ("grid_1m.features", "build_unchanged"),
    ("facebook.features", "half_walks"),
    ("grid_1m.features", "value_altered"),
])
def test_a_planted_fault_makes_the_run_incorrect(workload, fault, tmp_path):
    from gpbench.core import faults

    undo = faults.plant(fault)
    try:
        # 40 observations among the tiny grid's 400 nodes overlap, so the SLQ
        # estimate varies over probes and half of them give another mean
        r = run_tiny(workload, tmp_path, initial_points=40 if fault == "half_batch" else None)
    finally:
        undo()
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


def test_a_solver_setting_the_algorithm_does_not_run_is_refused(tmp_path):
    cfg, trf = tiny("grid_1m.bo_b100", tmp_path)
    cfg["bo"]["num_probes"] = 8
    with pytest.raises(ValueError, match="num_probes"):
        cell.run("grid_1m.bo_b100", 5, 0.5, False, device="cpu", config=cfg, traffic=trf)


def test_a_probe_whose_target_is_gone_raises():
    from gpbench.core.probes import Probes

    p = Probes(False)
    with pytest.raises(AttributeError, match="no_such_product"):
        p.spanned(peaks, "no_such_product", "k1")


# --- found by name ---------------------------------------------------------------


def test_a_new_config_mix_and_metric_are_files_and_entries(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(mf.HERE, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = mf.config("grid_1m")
    cfg.update(name="grid_tiny", reduced=["iterations", "n_nodes"])
    cfg["graph"]["n_nodes"] = 256
    cfg["walks"]["walks_per_node"] = 16
    (bench / "configs" / "grid_tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "features_burst.json").write_text(json.dumps(
        {"loop": "features", "why": "a mix added as data"}))
    (bench / "metrics" / "builds_done.py").write_text(
        'LAYER = "preprocessing"\nUNIT = "count"\nSOURCE = "program_counter"\n'
        'MOVES = "features_s"\n\ndef read(ctx):\n'
        '    return len(ctx["probes"].captures.get("builds", [])) or None\n')
    (bench / "limits" / "grid_tiny.features_burst.json").write_text(
        (bench / "limits" / "grid_1m.features.json").read_text())
    man = copy.deepcopy(M)
    man["configs"].append({"name": "grid_tiny", "source": "https://example.org/grid",
                           "file": "gpbench/configs/grid_tiny.json", "reduced": cfg["reduced"],
                           "why": "a configuration added as a file"})
    man["workloads"].append({"name": "grid_tiny.features_burst", "config": "grid_tiny",
                             "traffic": "features_burst", "chips": 1, "why": "added"})
    man["per_layer"].append({"name": "builds_done", "unit": "count", "better": "higher",
                             "source": "program_counter", "layer": "preprocessing",
                             "moves": "features_s", "workloads": ["grid_tiny.features_burst"]})
    for m in man["end_to_end"]:
        if m["name"] == "features_s":
            m["workloads"].append("grid_tiny.features_burst")
    plain = cell.run("grid_tiny.features_burst", 7, 0.3, False, device="cpu", bench=str(bench),
                     manifest=man)
    assert plain["correct"] and set(plain["metrics"]) == {"features_s", "setup_s"}
    traced = cell.run("grid_tiny.features_burst", 7, 0.3, True, device="cpu", bench=str(bench),
                      manifest=man)
    assert traced["metrics"]["builds_done"]["value"] >= 1


# --- what the harness loads --------------------------------------------------------


def _loaded_by(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_loads_no_jax_and_the_reference_none_of_the_program():
    code = (
        "import sys, json; sys.path.insert(0, '.');"
        "import gpbench.reference.checks, gpbench.reference.grf, gpbench.reference.gp;"
        "ref = sorted({m.split('.')[0] for m in sys.modules});"
        "import gpbench.run; from gpbench.core import cell, program, trace;"
        "from gpbench.core import manifest as mf;"
        "[mf.loop(n) for n in ('bo', 'features')];"
        "[mf.metric_reader(m['name']) for m in mf.load()['per_layer']];"
        "import graphgp_tpu_torch.cli.bo, graphgp_tpu_torch.bo, graphgp_tpu_torch.preprocessor;"
        "print(json.dumps({'ref': ref, 'all': sorted({m.split('.')[0] for m in sys.modules})}))"
    )
    got = _loaded_by(code)
    assert "graphgp_tpu_torch" not in got["ref"]
    for name in cell.FORBIDDEN_MODULES:
        assert name not in got["all"]
    assert "graphgp_tpu_torch" in got["all"]


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "graphgp_tpu_torch_extra", sys)
    assert "graphgp_tpu" not in cell.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in cell.forbidden_loaded()


def test_run_py_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "gpbench/run.py", "--workload", CELLS[0], "--seed",
                          "3", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


# --- the yardstick's arithmetic ------------------------------------------------------


def test_byte_counts_match_hand_counts():
    # K1 at the flagship's S = 9, B = 16, N = 1e6: weights once, input and output once
    assert peaks.stencil_work(9, 16, 10**6) == (4 * (9e6 + 32e6), 2 * 9 * 16 * 1e6)
    # an ELL of 3 live entries among 8 padded slots, B = 2, 4 rows, 5 columns
    assert peaks.sparse_work(3, 2, 4, 5) == (8 * 3 + 4 * 2 * 9, 2 * 3 * 2)
    assert peaks.bound_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.share_percent(3.35e9, 0, 2e-3) == pytest.approx(50.0)


def test_the_counters_count_each_call_at_its_call_site(tmp_path):
    from graphgp_tpu_torch import features
    from graphgp_tpu_torch.cuda_kernels import stencil

    c = cell.Cell(M["workloads"][0], {}, {}, 1, "cpu", True, ROOT)
    mats = features.EllStepMatrices(
        cols=torch.tensor([[[0, 1, 0], [2, 0, 0]]], dtype=torch.int32),
        vals=torch.tensor([[[0.5, 0.25, 0.0], [1.0, 0.0, 0.0]]]), num_target_nodes=3)
    feats = features.with_transpose(features.EllFeatures(mats))
    from gpbench.core import program

    program.install_operator_counters(c, feats)
    try:
        f = torch.ones(1)
        feats.matvec_bm(f, torch.ones(2, 3))
        feats.rmatvec_bm(f, torch.ones(2, 2))
        stencil._product(torch.ones(2, 8), torch.ones(3, 8), (0, 1))
    finally:
        c.probes.restore()
    k = c.probes.counters
    assert k["calls.ell"] == 2 and k["bytes.ell"] == 2 * (8 * 3 + 4 * 2 * (2 + 3))
    assert k["calls.k1"] == 1 and k["bytes.k1"] == 4 * (2 * 8 + 2 * 3 * 8)


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "gpbench/run.py", "--workload", "grid_1m.features",
                          "--seed", "2147483001", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS and line["correct"]
