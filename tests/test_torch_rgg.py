"""The random geometric graph generator (``data/synthetic.generate_rgg_data``,
the construction of DIMACS10's ``rgg_n_2_*`` graphs) against a plain
brute-force reference, and the BO CLI reaching it by name."""
import numpy as np
import pytest
import scipy.sparse as sp

from graphgp_tpu_torch.data import synthetic


def _points(n, seed):
    return np.random.default_rng(seed).random((n, 2))


def _brute_force(pts, r, block=512):
    """Every ordered pair closer than r, by direct distance, in row blocks."""
    n = len(pts)
    rows, cols = [], []
    for s in range(0, n, block):
        d = pts[s : s + block, None, :] - pts[None, :, :]
        i, j = np.nonzero(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] < r * r)
        keep = i + s != j
        rows.append(i[keep] + s)
        cols.append(j[keep])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n))


@pytest.mark.parametrize("n", [2048, 4096])
def test_the_edges_equal_a_brute_force_reference(n):
    a = synthetic.generate("rgg", n, seed=7)["adjacency"]
    ref = _brute_force(_points(n, 7), synthetic.rgg_radius(n))
    assert a.nnz == ref.nnz > 0
    assert (a != ref).nnz == 0


def test_the_graph_is_symmetric_unit_weighted_and_loop_free():
    a = synthetic.generate("rgg", 4096, seed=3)["adjacency"]
    assert (a != a.T).nnz == 0
    assert np.all(a.data == 1.0)
    assert np.all(a.diagonal() == 0)


def test_y_true_is_the_flagship_bump_at_the_points():
    n = 3000
    g = synthetic.generate("rgg", n, seed=11)
    rng = np.random.default_rng(11)
    x, y = rng.random((n, 2)).T
    bump = (1.2 * np.sin(2 * np.pi * x) + 0.6 * np.cos(3 * np.pi * y)
            + 3 * np.exp(-0.5 * (((x - 0.5) / 0.06) ** 2 + ((y - 0.5) / 0.06) ** 2)))
    np.testing.assert_array_equal(g["y_true"], bump.astype(np.float32))
    np.testing.assert_array_equal(g["y_observed"],
                                  (bump + rng.normal(0, 0.1, n)).astype(np.float32))
    np.testing.assert_array_equal(g["node_ids"], np.arange(n))


def test_the_mean_degree_is_the_constructions():
    n = 1 << 14
    a = synthetic.generate("rgg", n, seed=42)["adjacency"]
    expected = np.pi * 0.55 ** 2 * np.log(n)
    assert abs(a.nnz / n / expected - 1) < 0.05


def test_the_bo_cli_runs_grf_thompson_on_an_rgg_on_the_cpu(tmp_path):
    from graphgp_tpu_torch.cli.bo import main

    recs = main([
        "--graph-type", "rgg", "--n-nodes", "2048", "--algorithms", "grf_thompson",
        "--iterations", "2", "--bo-seeds", "100", "--walks-per-node", "8", "--p-halt", "0.1",
        "--max-walk-length", "3", "--batch-size", "4", "--initial-points", "10",
        "--train-epochs", "2", "--gp-retrain-interval", "1", "--cg-tol", "1e-2",
        "--seed", "42", "--device", "cpu",
        "--results-dir", str(tmp_path / "r"), "--cache-dir", str(tmp_path / "c"),
    ])
    regret = np.asarray([r["regret"] for r in recs])
    assert len(recs) == 2 and all(r["n_nodes"] == 2048 for r in recs)
    assert {r["graph_type"] for r in recs} == {"rgg"}
    assert np.isfinite(regret).all() and np.all(np.diff(regret) <= 0)
