"""The GCN baseline (``baselines/gnn.py``) against the JAX package, and the
traffic CLI's ``--gnn-baseline`` and dataset graphs on the CPU.

Parameters and node features cross over from the JAX package
(``convert.gcn_params_from_jax``), so both packages start from the same
numbers: the propagation matrix agrees to rel 1e-6 (both build it in
float64), the forward to rel 1e-5 (float32 products in another order), and
50 Adam steps' losses to rel 1e-3.

``--graph-type pems_bay`` reads the shipped ``processed_data/pems_bay.npz``
through the dataset loader, whose data root must exist
(``GRAPHGP_DATA_ROOT``, a temporary directory here); the data the CLI fits
are captured at ``gp.spectral.fit`` in both packages.
"""
import os

import numpy as np
import pytest
import torch

from graphgp_tpu_torch import convert
from graphgp_tpu_torch.baselines import gnn
from graphgp_tpu_torch.cli import regression
from graphgp_tpu_torch.data import synthetic


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch work on one intra-op thread: its ops are small, and
    beside other test processes threads that wait by spinning make them many
    times slower (the thread count is restored after the file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def grid():
    d = synthetic.generate("grid", 144, seed=0)
    rng = np.random.default_rng(0)
    perm = rng.permutation(144)
    return d["adjacency"], np.sort(perm[:100]), np.sort(perm[100:]), \
        d["y_observed"].astype(np.float32)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_propagation_matrix_matches_jax(grid, dense):
    from graphgp_tpu.baselines import gnn as jgnn

    adj = grid[0].toarray() if dense else grid[0]
    ours = gnn.gcn_propagation_matrix(adj).numpy()
    ref = np.asarray(jgnn.gcn_propagation_matrix(adj))
    assert ours.dtype == np.float32 and _rel(ours, ref) <= 1e-6
    np.testing.assert_allclose(ours, ours.T, rtol=0, atol=0)


def _jax_start(in_dim, hidden, seed=3):
    import jax

    from graphgp_tpu.baselines import gnn as jgnn

    params = jgnn.init_gcn(jax.random.PRNGKey(seed), in_dim, hidden)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("hidden", [(16,), (64, 64)], ids=["one-hidden", "two-hidden"])
def test_forward_matches_jax(grid, hidden):
    import jax.numpy as jnp

    from graphgp_tpu.baselines import gnn as jgnn

    adj = grid[0]
    x = np.random.default_rng(1).normal(size=(144, 8)).astype(np.float32)
    params = _jax_start(8, hidden)
    ref = np.asarray(jgnn.gcn_forward({k: jnp.asarray(v) for k, v in params.items()},
                                      jgnn.gcn_propagation_matrix(adj), jnp.asarray(x)))
    model = gnn.GCN(8, hidden)
    model.load_state_dict(convert.gcn_params_from_jax(params))
    with torch.no_grad():
        ours = model(gnn.gcn_propagation_matrix(adj), torch.from_numpy(x)).numpy()
    assert ours.shape == (144,) and _rel(ours, ref) <= 1e-5


def test_gcn_init_is_he_normal():
    model = gnn.GCN(32, (64, 64), generator=torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {"w0": (32, 64), "b0": (64,), "w1": (64, 64), "b1": (64,),
                      "w2": (64, 1), "b2": (1,)}
    assert abs(float(model.w1.detach().std()) - np.sqrt(2 / 64)) < 0.02
    assert all(float(model.state_dict()[f"b{i}"].abs().max()) == 0 for i in range(3))


def test_fit_gcn_losses_match_jax(grid):
    import jax
    import jax.numpy as jnp
    import optax

    from graphgp_tpu.baselines import gnn as jgnn

    adj, tr, _, y = grid
    x = (0.1 * np.random.default_rng(2).normal(size=(144, 32))).astype(np.float32)
    params = _jax_start(32, (64, 64))
    # the JAX package's training loop, from the same start and features
    a_hat = jgnn.gcn_propagation_matrix(adj)
    jx, jy, jtr = jnp.asarray(x), jnp.asarray(y[tr]), jnp.asarray(tr)
    opt = optax.adam(1e-2)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    loss_grad = jax.jit(jax.value_and_grad(
        lambda q: jnp.mean((jgnn.gcn_forward(q, a_hat, jx)[jtr] - jy) ** 2)))
    ref = []
    for _ in range(50):
        loss, g = loss_grad(p)
        upd, state = opt.update(g, state, p)
        p = optax.apply_updates(p, upd)
        ref.append(float(loss))
    res = gnn.fit_gcn(adj, torch.from_numpy(tr), torch.from_numpy(y[tr]), num_steps=50,
                      node_features=torch.from_numpy(x),
                      init=convert.gcn_params_from_jax(params))
    ours = res.losses.numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-3)
    assert ours[-1] < ours[0] * 0.5
    assert res.predictions.shape == (144,) and set(res.params) == set(params)


def test_fit_gcn_learns_without_features(grid):
    """The JAX package's own check, on the port: random positional features."""
    adj, tr, te, y = grid
    res = gnn.fit_gcn(adj, torch.from_numpy(tr), torch.from_numpy(y[tr]), num_steps=400,
                      generator=torch.Generator().manual_seed(0))
    assert float(res.losses[-1]) < float(res.losses[0]) * 0.5
    rmse = float(torch.sqrt(torch.mean((res.predictions[te] - torch.from_numpy(y[te])) ** 2)))
    assert rmse < float(np.std(y))


def test_gcn_params_from_jax_rejects_other_names():
    with pytest.raises(ValueError, match="GCN parameters"):
        convert.gcn_params_from_jax({"w0": np.zeros((2, 1)), "bias": np.zeros(1)})


def test_regression_gnn_baseline_adds_a_finite_gcn_row(tmp_path):
    recs = regression.main(["--device", "cpu", "--n-nodes", "49", "--num-train", "30",
                            "--seeds", "1", "--walks", "8", "--train-steps", "5",
                            "--max-walk-length", "4", "--gnn-baseline",
                            "--results-dir", str(tmp_path)])
    gcn = [r for r in recs if r["kernel"] == "gcn"]
    assert len(gcn) == 1 and np.isfinite(gcn[0]["rmse"])
    assert np.isnan(gcn[0]["lml"]) and np.isnan(gcn[0]["nlpd"])
    assert [r["kernel"] for r in recs][:4] == [
        "exact_diffusion", "pofm_diffusion", "pofm_free", "gcn"]


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    root = tmp_path / "raw"
    root.mkdir()
    monkeypatch.setenv("GRAPHGP_DATA_ROOT", str(root))
    return root


def _capture_fit_data(monkeypatch, spectral_mod):
    seen = []
    real_eig, real_fit = spectral_mod.eigenbasis, spectral_mod.fit

    def eigenbasis(adj, *args, **kwargs):
        seen.append(("adjacency", adj))
        return real_eig(adj, *args, **kwargs)

    def fit(eig, tr, y, *args, **kwargs):
        seen.append(("fit", np.asarray(tr).astype(np.int64), np.asarray(y)))
        return real_fit(eig, tr, y, *args, **kwargs)

    monkeypatch.setattr(spectral_mod, "eigenbasis", eigenbasis)
    monkeypatch.setattr(spectral_mod, "fit", fit)
    return seen


def test_regression_on_the_pems_bay_dataset_matches_jax(data_root, tmp_path, monkeypatch):
    """``--graph-type pems_bay`` through the loader: the same adjacency, the
    same targets after ``--obs-noise`` and the same split as the JAX CLI, and
    the same record keys, the GCN row included."""
    from graphgp_tpu.cli import regression as jregression
    from graphgp_tpu.gp import spectral as jspectral

    from graphgp_tpu_torch.gp import spectral as tspectral

    argv = ["--graph-type", "pems_bay", "--obs-noise", "0.45", "--walks", "4",
            "--train-steps", "3", "--seeds", "1", "--max-walk-length", "4", "--gnn-baseline"]
    seen_t = _capture_fit_data(monkeypatch, tspectral)
    ours = regression.main([*argv, "--device", "cpu", "--results-dir", str(tmp_path / "p")])
    seen_j = _capture_fit_data(monkeypatch, jspectral)
    ref = jregression.main([*argv, "--results-dir", str(tmp_path / "j")])
    (_, adj_t), (_, tr_t, y_t) = seen_t
    (_, adj_j), (_, tr_j, y_j) = seen_j
    assert adj_t.shape == (321, 321) and (adj_t != adj_j).nnz == 0
    np.testing.assert_array_equal(tr_t, tr_j)
    np.testing.assert_array_equal(y_t, y_j)
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref]
    assert [r["kernel"] for r in ours] == [r["kernel"] for r in ref]
    gcn = [r for r in ours if r["kernel"] == "gcn"]
    assert len(gcn) == 1 and np.isfinite(gcn[0]["rmse"])
    assert os.listdir(data_root) == []  # read from the shipped cache only


def test_regression_unknown_graph_type_raises_in_both(data_root, tmp_path):
    from graphgp_tpu.cli import regression as jregression

    with pytest.raises(ValueError, match="unknown dataset 'nope'"):
        regression.main(["--graph-type", "nope", "--device", "cpu",
                         "--results-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="unknown dataset 'nope'"):
        jregression.main(["--graph-type", "nope", "--results-dir", str(tmp_path)])
