"""The facebook BO path: the dataset loader, walks on the shipped graph against
the JAX package, and ``cli/bo`` on facebook at a tiny depth on the CPU.

The graph ships as ``processed_data/facebook.npz`` (N = 22470, 341646
nonzeros of the adjacency). Walks and loaders are exact. JAX is imported
inside the tests that compare with it, so the ``gpu`` tests at the end run
on a machine without it:
    python -m pytest --noconftest -m gpu -q tests/test_torch_facebook.py
They check that the ELL and transposed products repeat bit for bit on the
card and agree with the CPU within float32 summation order (1e-5 of max
|ref|), and that the card builds the same transpose.
"""
import gzip
import os
import re

import numpy as np
import pytest
import torch

from graphgp_tpu_torch import features as tfeat
from graphgp_tpu_torch import graphs as tgraphs
from graphgp_tpu_torch import walker as twalker
from graphgp_tpu_torch.data import database as tdb

CACHE = "processed_data"
N_FACEBOOK = 22470
NNZ_FACEBOOK = 341646


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    """An existing directory for the loader's data root, named the way the
    drivers read it."""
    root = tmp_path / "raw"
    root.mkdir()
    monkeypatch.setenv("GRAPHGP_DATA_ROOT", str(root))
    return root


@pytest.fixture(scope="module")
def facebook():
    return tdb._load_csr_npz(os.path.join(CACHE, "facebook.npz"))


def test_loader_returns_the_shipped_facebook_graph(data_root):
    data = tdb.GraphDataLoader(cache_dir=CACHE)("facebook")
    adj = data["adjacency"]
    assert adj.shape == (N_FACEBOOK, N_FACEBOOK) and adj.nnz == NNZ_FACEBOOK
    assert (adj != adj.T).nnz == 0 and adj.diagonal().sum() == 0
    np.testing.assert_array_equal(data["y_observed"], tdb._degree_targets(adj))
    np.testing.assert_array_equal(data["y_true"], data["y_observed"])
    assert data["y_observed"].dtype == np.float32
    assert list(os.listdir(data_root)) == []  # nothing read or written there


def test_loader_matches_jax_on_facebook(data_root):
    from graphgp_tpu.data.database import GraphDataLoader as JaxLoader

    ours = tdb.GraphDataLoader(cache_dir=CACHE)("facebook")
    ref = JaxLoader(data_root=str(data_root), cache_dir=CACHE)("facebook")
    for k in ("node_ids", "y_observed", "y_true"):
        np.testing.assert_array_equal(ours[k], ref[k])
    assert (ours["adjacency"] != ref["adjacency"]).nnz == 0


def test_loader_registry_names_equal_jax(data_root):
    from graphgp_tpu.data.database import GraphDataLoader as JaxLoader

    ours = tdb.GraphDataLoader(cache_dir=CACHE)
    ref = JaxLoader(data_root=str(data_root), cache_dir=CACHE)
    assert ours.available() == ref.available()
    assert {k: v[0] for k, v in ours.registry.items()} == {k: v[0] for k, v in ref.registry.items()}


def test_loader_needs_an_existing_data_root(tmp_path, monkeypatch):
    monkeypatch.delenv("GRAPHGP_DATA_ROOT", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="GRAPHGP_DATA_ROOT"):
        tdb.GraphDataLoader()


def test_loader_unknown_and_missing_datasets_raise(data_root, tmp_path):
    loader = tdb.GraphDataLoader(cache_dir=str(tmp_path / "cache"))
    with pytest.raises(ValueError, match="unknown dataset"):
        loader("nope")
    with pytest.raises(FileNotFoundError, match="not found"):
        loader("twitch")


def _write_edges_csv(path, header, edges):
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = [",".join(header)] + [f"{a},{b}" for a, b in edges]
    path.write_text("\n".join(lines) + "\n")


EDGES = [(10, 3), (3, 7), (7, 10), (10, 10), (3, 7), (42, 3), (8, 42)]


@pytest.mark.parametrize("name", ["facebook", "twitch", "enron"])
def test_raw_edge_files_load_like_jax_and_are_cached(data_root, tmp_path, name):
    """Raw edge lists (CSV with a header, or gzipped text): the same graph,
    ids and degree targets as the JAX loader, then read from the cache."""
    from graphgp_tpu.data.database import GraphDataLoader as JaxLoader

    rel = tdb.GraphDataLoader(cache_dir=str(tmp_path / "c0")).registry[name][0]
    path = data_root / rel
    if name == "enron":
        path.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(path, "wt") as fh:
            fh.write("# comment\n" + "".join(f"{a}\t{b}\n" for a, b in EDGES))
    else:
        header = ("id_1", "id_2") if name == "facebook" else ("numeric_id_1", "numeric_id_2")
        _write_edges_csv(path, header, EDGES)
    ours = tdb.GraphDataLoader(cache_dir=str(tmp_path / "ours"))(name)
    ref = JaxLoader(data_root=str(data_root), cache_dir=str(tmp_path / "jax"))(name)
    assert (ours["adjacency"] != ref["adjacency"]).nnz == 0
    np.testing.assert_array_equal(ours["y_observed"], ref["y_observed"])
    np.testing.assert_array_equal(ours["node_ids"], ref["node_ids"])
    assert os.path.exists(tmp_path / "ours" / f"{name}.npz")
    again = tdb.GraphDataLoader(cache_dir=str(tmp_path / "ours"))(name)
    assert (again["adjacency"] != ours["adjacency"]).nnz == 0


def test_pems_distance_table_loads_like_jax(data_root, tmp_path):
    from graphgp_tpu.data.database import _load_pems_bay_distances as jax_pems

    rng = np.random.default_rng(0)
    ids = np.asarray([400001, 400017, 400030, 400045, 400052, 400057])
    # whole metres: pandas' default float parser (the JAX loader's) is not
    # correctly rounded, the csv module's float() is
    rows = [(a, b, float(rng.integers(100, 3000))) for a in ids for b in ids if rng.random() < 0.6]
    rows.append((ids[0], ids[0], 0.0))
    path = tmp_path / "distances.csv"
    path.write_text("".join(f"{a},{b},{d}\n" for a, b, d in rows))
    a_o, ids_o, y_o = tdb._load_pems_bay_distances(str(path))
    a_r, ids_r, y_r = jax_pems(str(path))
    assert abs(a_o - a_r).max() == 0
    np.testing.assert_array_equal(ids_o, ids_r)
    np.testing.assert_array_equal(y_o, y_r)


def test_edges_to_csr_matches_jax():
    from graphgp_tpu.data.database import edges_to_csr as jax_edges

    u, v = np.asarray(EDGES).T
    a_o, n_o = tdb.edges_to_csr(u, v)
    a_r, n_r = jax_edges(u, v)
    assert (a_o != a_r).nnz == 0
    np.testing.assert_array_equal(n_o, n_r)


# ---------------------------------------------------------------------------
# Walks on the shipped graph
# ---------------------------------------------------------------------------


def test_facebook_packs_as_csr_like_jax(facebook):
    from graphgp_tpu import graphs as jgraphs

    adj = facebook[0]
    tg = tgraphs.pack_laplacian(adj)
    jg = jgraphs.pack_laplacian(adj)
    assert isinstance(tg, tgraphs.CsrGraph) and isinstance(jg, jgraphs.CsrGraph)
    assert tg.num_nodes == N_FACEBOOK and tg.nnz == NNZ_FACEBOOK + N_FACEBOOK
    assert int(tg.degree.max()) == 709 + 1  # the largest degree and the diagonal
    np.testing.assert_array_equal(tg.node_table.numpy(), np.asarray(jg.node_table))
    np.testing.assert_array_equal(tg.neighbors.numpy(), np.asarray(jg.edge_table)[:, 0])
    np.testing.assert_array_equal(tg.weights.numpy(), np.asarray(jg.edge_table)[:, 1])


def test_facebook_walks_first_2048_start_nodes_bit_identical_to_jax(facebook):
    import jax

    from graphgp_tpu import graphs as jgraphs
    from graphgp_tpu import walker as jwalker

    adj = facebook[0]
    ref = jwalker.sample_walk_log(jgraphs.pack_laplacian(adj), jax.random.PRNGKey(42),
                                  jwalker.WalkConfig(16, 0.1, 5), num_start_nodes=2048)
    got = twalker.sample_walk_log(tgraphs.pack_laplacian(adj), 42, twalker.WalkConfig(16, 0.1, 5),
                                  num_start_nodes=2048)
    np.testing.assert_array_equal(got.curs.numpy(), np.asarray(ref.curs))
    np.testing.assert_array_equal(got.loads.numpy(), np.asarray(ref.loads))
    assert int((got.curs[1:] != got.curs[:1]).sum()) > 0  # the walks move


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


def test_bo_cli_runs_grf_thompson_on_facebook_on_the_cpu(data_root, tmp_path):
    from graphgp_tpu_torch.cli.bo import main

    recs = main([
        "--graph-type", "facebook", "--algorithms", "grf_thompson", "--iterations", "2",
        "--bo-seeds", "100", "--walks-per-node", "8", "--p-halt", "0.1",
        "--max-walk-length", "3", "--batch-size", "1", "--initial-points", "10",
        "--train-epochs", "3", "--gp-retrain-interval", "10", "--cg-tol", "1e-2",
        "--gaussianize", "--seed", "42", "--device", "cpu",
        "--results-dir", str(tmp_path / "r"), "--cache-dir", str(tmp_path / "c"),
    ])
    regret = np.asarray([r["regret"] for r in recs])
    assert len(recs) == 2 and all(r["n_nodes"] == N_FACEBOOK for r in recs)
    assert {r["graph_type"] for r in recs} == {"facebook"}
    assert np.isfinite(regret).all() and np.all(np.diff(regret) <= 0)
    assert len(list((tmp_path / "c").glob("*.csc.npz"))) == 1  # ELL + transpose, cached
    assert (tmp_path / "r" / "bo.csv").exists()


def test_bo_cli_unknown_graph_type_names_both_kinds(data_root, tmp_path):
    from graphgp_tpu_torch.cli.bo import main

    recs = main(["--graph-type", "nope", "--algorithms", "random_search", "--device", "cpu",
                 "--results-dir", str(tmp_path)])
    assert len(recs) == 1 and set(recs[0]) == {"graph_type", "error"}
    assert recs[0]["graph_type"] == "nope"
    assert re.search(r"ValueError: .*synthetic generators:.*datasets:.*facebook", recs[0]["error"])


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def facebook_ell(facebook):
    """ELL step matrices of the first 4096 start nodes (wpn 16, L 5) and
    their transpose, on the CPU."""
    g = tgraphs.pack_laplacian(facebook[0])
    cfg = twalker.WalkConfig(16, 0.1, 5)
    log = twalker.sample_walk_log(g, 42, cfg, num_start_nodes=4096)
    mats = tfeat.consolidate(log, tfeat.suggest_row_capacity(log), num_target_nodes=g.num_nodes,
                             walks_per_node=16)
    return tfeat.with_transpose(tfeat.EllFeatures(mats))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.cpu() - b).abs().max() / b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 17])
def test_products_repeat_bit_for_bit_on_the_card(cuda, facebook_ell, b):
    gpu = facebook_ell.to(cuda)
    f = torch.tensor([1.0, 0.7, -0.4, 0.25, 0.1])
    g = torch.Generator().manual_seed(b)
    v_t = torch.randn((b, gpu.num_target_nodes), generator=g)
    v_s = torch.randn((b, gpu.num_nodes), generator=g)
    for op, v in (("matvec_bm", v_t), ("rmatvec_bm", v_s)):
        first = getattr(gpu, op)(f.to(cuda), v.to(cuda))
        second = getattr(gpu, op)(f.to(cuda), v.to(cuda))
        assert torch.equal(first, second), op
        assert _rel(first, getattr(facebook_ell, op)(f, v)) <= 1e-5, op


@pytest.mark.gpu
def test_transpose_on_the_card_equals_the_cpu(cuda, facebook_ell):
    csc = tfeat.transpose_ell(facebook_ell.mats.to(cuda))
    for name in ("rows", "vals", "seg_start", "last_pos", "has_any", "vrow_ptr"):
        assert torch.equal(getattr(csc, name).cpu(), getattr(facebook_ell.csc, name)), name
    assert csc.used_vrows == facebook_ell.csc.used_vrows


@pytest.mark.gpu
def test_facebook_walks_on_the_card_equal_the_cpu(cuda, facebook):
    g = tgraphs.pack_laplacian(facebook[0])
    cfg = twalker.WalkConfig(16, 0.1, 5)
    cpu = twalker.sample_walk_log(g, 42, cfg, num_start_nodes=1024)
    card = twalker.sample_walk_log(g.to(cuda), 42, cfg, num_start_nodes=1024)
    assert torch.equal(card.curs.cpu(), cpu.curs) and torch.equal(card.loads.cpu(), cpu.loads)
