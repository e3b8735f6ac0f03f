"""The port's BO driver end to end on a small grid (``--device cpu``), against
the JAX driver where the two must agree, and the step-matrix cache shared by
both packages."""
import csv

import jax
import numpy as np
import pytest
import torch

from graphgp_tpu import walker as jwalker
from graphgp_tpu.cli.bo import main as jax_bo_main
from graphgp_tpu.data.synthetic import generate
from graphgp_tpu.preprocessor import preprocess_graph as jax_preprocess
from graphgp_tpu_torch import walker as twalker
from graphgp_tpu_torch.bo import GRFThompson
from graphgp_tpu_torch.cli.bo import main as torch_bo_main
from graphgp_tpu_torch.features import EllFeatures, StencilFeatures
from graphgp_tpu_torch.preprocessor import preprocess_graph as torch_preprocess

TRAVERSALS = ["random_search", "bfs", "dfs", "greedy_search"]


def _common_flags(tmp_path, sub):
    return ["--graph-type", "grid", "--n-nodes", "100", "--iterations", "4", "--runs", "2",
            "--batch-size", "3", "--initial-points", "5",
            "--results-dir", str(tmp_path / sub), "--cache-dir", str(tmp_path / "cache")]


def test_traversals_pick_the_same_nodes_as_jax(tmp_path):
    jax_recs = jax_bo_main(_common_flags(tmp_path, "jax") + ["--algorithms", *TRAVERSALS])
    torch_recs = torch_bo_main(_common_flags(tmp_path, "torch")
                               + ["--algorithms", *TRAVERSALS, "--device", "cpu"])
    key = lambda r: (r["algorithm"], r["seed"], r["iteration"])
    jax_by = {key(r): r for r in jax_recs}
    assert len(torch_recs) == len(jax_recs) == 4 * 2 * 4
    for r in torch_recs:
        ref = jax_by[key(r)]
        for field in ("best_point", "best_value", "regret", "dataset_size", "batch_mean"):
            assert r[field] == ref[field], (key(r), field)
    with open(tmp_path / "torch" / "bo.csv") as fh:
        assert len(list(csv.DictReader(fh))) == len(torch_recs)


def test_grf_thompson_cli_regret_finite_and_non_increasing(tmp_path):
    recs = torch_bo_main([
        "--graph-type", "grid", "--n-nodes", "144", "--algorithms", "grf_thompson",
        "--iterations", "4", "--bo-seeds", "100", "110", "--batch-size", "4",
        "--initial-points", "6", "--walks-per-node", "40", "--max-walk-length", "4",
        "--train-epochs", "3", "--device", "cpu",
        "--results-dir", str(tmp_path / "r"), "--cache-dir", str(tmp_path / "c"),
    ])
    for seed in (100, 110):
        regret = np.asarray([r["regret"] for r in recs if r["seed"] == seed])
        assert regret.size == 4 and np.isfinite(regret).all()
        assert np.all(np.diff(regret) <= 0)
    picks = {s: [r["best_point"] for r in recs if r["seed"] == s] for s in (100, 110)}
    assert picks[100] != picks[110]


def _small_stencil_features(n=144, wpn=40):
    adj = generate("grid", n, seed=0)["adjacency"]
    return torch_preprocess(adj, twalker.WalkConfig(wpn, 0.1, 4), layout="auto", device="cpu")


def test_thompson_draws_follow_the_bo_seed():
    """Thompson draws depend on the per-seed host rng (a fixed key once made
    every protocol seed identical: regret std 0.0000)."""
    feats = _small_stencil_features()
    y = generate("grid", 144, seed=0)["y_observed"]
    obs = np.arange(0, 144, 12)

    def picks(seed):
        algo = GRFThompson(feats, 144, np.random.default_rng(seed), train_epochs=2, device="cpu")
        return algo.select_next_points(obs, y[obs], batch_size=8)

    assert picks(1) == picks(1)
    assert picks(1) != picks(2)


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats = _small_stencil_features()
    with pytest.raises(RuntimeError, match="cpu"):
        GRFThompson(feats, 144, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="cpu"):
        torch_preprocess(generate("grid", 144)["adjacency"], twalker.WalkConfig(8, 0.1, 3))
    with pytest.raises(RuntimeError, match="cpu"):
        torch_bo_main(["--algorithms", "random_search", "--results-dir", str(tmp_path)])


@pytest.mark.parametrize("kind", ["grid", "periodic_grid"])
def test_jax_cache_loads_in_the_port_and_back(tmp_path, kind):
    adj = generate(kind, 256, seed=0)["adjacency"]
    cfg = dict(walks_per_node=32, p_halt=0.1, max_walk_length=4)
    jax_dir, torch_dir = str(tmp_path / "jax"), str(tmp_path / "torch")

    ref = jax_preprocess(adj, jwalker.WalkConfig(**cfg), seed=3, cache_dir=jax_dir, layout="auto")
    got = torch_preprocess(adj, twalker.WalkConfig(**cfg), seed=3, cache_dir=jax_dir,
                           layout="auto", device="cpu")
    assert isinstance(got, StencilFeatures)
    np.testing.assert_array_equal(got.mats.offsets, np.asarray(ref.mats.offsets))
    np.testing.assert_array_equal(got.mats.vals.numpy(), np.asarray(ref.mats.vals))
    ell_ref = jax_preprocess(adj, jwalker.WalkConfig(**cfg), seed=3, cache_dir=jax_dir)
    ell = torch_preprocess(adj, twalker.WalkConfig(**cfg), seed=3, cache_dir=jax_dir,
                           device="cpu")
    assert isinstance(ell, EllFeatures)
    np.testing.assert_array_equal(ell.mats.cols.numpy(), np.asarray(ell_ref.mats.cols))
    np.testing.assert_array_equal(ell.mats.vals.numpy(), np.asarray(ell_ref.mats.vals))

    # the port's own cache, from its own walks, reads back in the JAX package
    mine = torch_preprocess(adj, twalker.WalkConfig(**cfg), seed=3, cache_dir=torch_dir,
                            layout="auto", device="cpu")
    back = jax_preprocess(adj, jwalker.WalkConfig(**cfg), seed=3, cache_dir=torch_dir,
                          layout="auto")
    np.testing.assert_array_equal(np.asarray(back.mats.vals), mine.mats.vals.numpy())
    np.testing.assert_allclose(mine.mats.vals.numpy(), np.asarray(ref.mats.vals),
                               rtol=0, atol=1e-6)  # same walks, another summation order
