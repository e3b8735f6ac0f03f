"""The dense-regime CLIs of the port, end to end on the CPU at a tiny size
(``--device cpu``: K4's plain version), and what surrounds them:
``data/database._load_csr_npz`` and ``utils/io.compute_fro`` against the JAX
package.

The CLIs fit with ``torch.optim.LBFGS``, whose line search differs from
optax's, so they are held to what the protocols claim (finite metrics, every
row present, the principled estimator's kernel error falling with
walks_per_node and ending below the ad-hoc one's), not to the JAX iterates.
The quantities with no fit in them are compared with the JAX package:
``kernel_fro_rel`` is a function of the bit-identical walks (rtol 1e-4: a
float32 contraction and a float64 norm of a 36×36 matrix).
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgp_tpu.data import database as jdatabase
from graphgp_tpu.utils import io as jio
from graphgp_tpu_torch.cli import ablation, regression
from graphgp_tpu_torch.data import database as tdatabase
from graphgp_tpu_torch.utils import io as tio

PEMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "processed_data", "pems_bay.npz")


def test_load_csr_npz_matches_jax():
    adj_j, ids_j, y_j = jdatabase._load_csr_npz(PEMS)
    adj, ids, y = tdatabase._load_csr_npz(PEMS)
    assert adj.shape == adj_j.shape == (321, 321)
    assert (adj != adj_j).nnz == 0
    np.testing.assert_array_equal(ids, ids_j)
    np.testing.assert_array_equal(y, y_j)


def test_compute_fro_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(7, 7)), rng.normal(size=(7, 7))
    assert tio.compute_fro(a, b) == jio.compute_fro(a, b)
    assert tio.compute_fro(b, b) == 0.0


@pytest.fixture(scope="module")
def ablation_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("ablation")
    recs = ablation.main(["--device", "cpu", "--mesh-side", "6", "--seeds", "1",
                          "--walks", "4", "400", "--train-steps", "15", "--max-walk-length", "6",
                          "--results-dir", str(out)])
    return recs, out


def test_ablation_cli_end_to_end(ablation_records):
    recs, out = ablation_records
    assert [(r["mode"], r["walks_per_node"]) for r in recs] == [
        ("exact_diffusion", 0), ("principled", 4), ("ablation", 4),
        ("principled", 400), ("ablation", 400)]
    for r in recs:
        for k in ("rmse", "rmse_latent", "nlpd", "learned_noise_var", "final_loss"):
            assert np.isfinite(r[k]), (r["mode"], k)
    fro = {(r["mode"], r["walks_per_node"]): r["kernel_fro_rel"] for r in recs[1:]}
    assert fro[("principled", 400)] < fro[("principled", 4)]
    assert fro[("principled", 400)] < fro[("ablation", 400)]
    with open(out / "ablation.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 5 and rows[0]["mode"] == "exact_diffusion"
    assert (out / "ablation_config.json").exists()


def test_ablation_kernel_error_matches_jax(ablation_records):
    """``kernel_fro_rel`` has no fit in it: the JAX package's walks at
    ``PRNGKey(42 + seed)`` under the β = 1 diffusion modulator give the same
    number."""
    from graphgp_tpu.data.synthetic import _grid_adjacency
    from graphgp_tpu.kernels import features_for_adjacency
    from graphgp_tpu.modulators import diffusion_modulator

    recs, _ = ablation_records
    adj = _grid_adjacency(6).toarray()
    deg = adj.sum(axis=1)
    lap = np.eye(36) - adj / np.sqrt(deg)[:, None] / np.sqrt(deg)[None, :]
    evals, evecs = np.linalg.eigh(lap)
    target = (evecs * np.exp(-evals)) @ evecs.T
    f = jnp.asarray(diffusion_modulator(6, 1.0), jnp.float32)
    for rec in recs[1:]:
        feats = features_for_adjacency(
            adj, jax.random.PRNGKey(42 + rec["seed"]), walks_per_node=rec["walks_per_node"],
            p_halt=0.01, max_walk_length=6, ablation=rec["mode"] == "ablation")
        phi = np.asarray(feats.rows(f, jnp.arange(36, dtype=jnp.int32)))
        np.testing.assert_allclose(rec["kernel_fro_rel"], jio.compute_fro(phi @ phi.T, target),
                                   rtol=1e-4)


@pytest.fixture(scope="module")
def regression_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("regression")
    recs = regression.main(["--device", "cpu", "--n-nodes", "49", "--num-train", "30",
                            "--seeds", "1", "--walks", "2", "64", "--train-steps", "10",
                            "--max-walk-length", "5", "--results-dir", str(out)])
    return recs, out


def test_regression_cli_end_to_end(regression_records):
    recs, out = regression_records
    assert [(r["kernel"], r["walks_per_node"]) for r in recs] == [
        ("exact_diffusion", 0), ("pofm_diffusion", 0), ("pofm_free", 0),
        ("grf_diffusion_transplant", 2), ("grf_diffusion", 2), ("grf_free", 2),
        ("grf_diffusion_transplant", 64), ("grf_diffusion", 64), ("grf_free", 64)]
    for r in recs:
        assert np.isfinite(r["rmse"]) and np.isfinite(r["nlpd"]), r["kernel"]
        assert np.isnan(r["lml"]) == (r["kernel"] == "grf_diffusion_transplant")
    assert recs[0]["beta"] > 0
    assert (out / "regression.csv").exists() and (out / "regression_config.json").exists()


def test_regression_cli_on_the_pems_graph(tmp_path, capsys):
    recs = regression.main(["--device", "cpu", "--pems-npz", PEMS, "--seeds", "1", "--walks", "8",
                            "--train-steps", "3", "--max-walk-length", "4",
                            "--results-dir", str(tmp_path)])
    assert "PEMS graph: 321 sensors" in capsys.readouterr().out
    assert len(recs) == 6 and all(np.isfinite(r["rmse"]) for r in recs)


def test_regression_cli_gp_field(tmp_path):
    recs = regression.main(["--device", "cpu", "--n-nodes", "36", "--num-train", "20",
                            "--seeds", "1", "--walks", "16", "--train-steps", "4",
                            "--max-walk-length", "4", "--gp-field", "2.0", "--obs-noise", "0",
                            "--results-dir", str(tmp_path)])
    assert len(recs) == 6 and all(np.isfinite(r["nlpd"]) for r in recs)


@pytest.mark.parametrize("cli", [ablation, regression], ids=["ablation", "regression"])
def test_clis_default_to_the_card_and_raise_without_one(cli, tmp_path):
    assert cli.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--results-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        cli.main(["--force-cpu"])  # the JAX flag is --device cpu here


def test_protocol_defaults_are_the_reference_settings():
    a = ablation.build_parser().parse_args([])
    assert (a.mesh_side, a.beta, a.amplitude, a.noise_std, a.p_halt, a.max_walk_length) == \
        (30, 10.0, 10.0, 0.5, 0.01, 10)
    assert (a.walks, a.seeds, a.train_steps, a.train_frac) == ([1, 10, 100, 1000], 3, 1000, 0.3)
    r = regression.build_parser().parse_args([])
    assert (r.graph_type, r.n_nodes, r.num_train, r.p_halt, r.max_walk_length) == \
        ("grid", 900, 250, 0.1, 10)
    assert (r.walks, r.train_steps, r.obs_noise, r.seeds) == ([1, 4, 16, 64, 256, 1024], 200, 0.1, 3)
