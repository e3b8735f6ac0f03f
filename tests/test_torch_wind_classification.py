"""The wind and classification paths on the CPU: the sphere-grid geometry,
the wind step matrices, the synthetic community graph and the Cora loaders
against the JAX package (all exact), and the two CLIs end to end at the JAX
tests' sizes (``tests/test_experiment_drivers.py``).

At the poles all the nodes of a latitude row coincide, so their east–west
weights are ~1e-17; the Laplacian goes through the float64 sparse path of
``pack_laplacian`` in both packages, and the walks from seed 42 are
bit-identical. The Cora files are fabricated in ``tmp_path`` as the JAX
tests do (the real ones are not in the repository). JAX is imported inside
the tests, so the ``gpu`` tests run without it:
    python -m pytest --noconftest -m gpu -q tests/test_torch_wind_classification.py
"""
import numpy as np
import pytest
import torch

from graphgp_tpu_torch.cli import classification, wind
from graphgp_tpu_torch.data import database as tdb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch work on one intra-op thread: its ops are small, and
    beside other test processes threads that wait by spinning make them many
    times slower (the thread count is restored after the file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grid(n_lat, n_lon):
    return np.linspace(-90, 90, n_lat), np.linspace(-180, 180, n_lon, endpoint=False)


@pytest.mark.parametrize("n_lat,n_lon", [(19, 36), (7, 12)], ids=["19x36", "7x12"])
def test_sphere_grid_wind_and_track_equal_jax(n_lat, n_lon):
    from graphgp_tpu.cli import wind as jwind

    lat, lon = _grid(n_lat, n_lon)
    a, r = wind.build_sphere_grid_graph(lat, lon), jwind.build_sphere_grid_graph(lat, lon)
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(a, name), getattr(r, name))
    np.testing.assert_array_equal(wind.synthetic_wind_speed(lat, lon),
                                  jwind.synthetic_wind_speed(lat, lon))
    np.testing.assert_array_equal(wind.orbit_track_nodes(lat, lon), jwind.orbit_track_nodes(lat, lon))
    np.testing.assert_array_equal(wind.sph2cart(lat, 2 * lat), jwind.sph2cart(lat, 2 * lat))
    assert np.abs(a - a.T).max() == 0 and a[3 * n_lon, 3 * n_lon + n_lon - 1] > 0  # wraparound


def test_sphere_grid_has_the_polar_rows_it_must_survive():
    lat, lon = _grid(19, 36)
    a = wind.build_sphere_grid_graph(lat, lon)
    assert a.shape == (684, 684) and a.nnz == 2664
    assert a.data.min() == pytest.approx(1.0673500e-17, rel=1e-6)
    assert wind.orbit_track_nodes(lat, lon).size == 290
    d = wind.great_circle_distance(np.array([0.0]), np.array([0.0]), np.array([0.0]),
                                   np.array([90.0]))
    assert d[0] == pytest.approx(np.pi / 2)


def test_wind_step_matrices_bit_identical_to_jax():
    import jax

    from graphgp_tpu.kernels import features_for_adjacency as jfeatures
    from graphgp_tpu_torch.kernels import features_for_adjacency

    lat, lon = _grid(19, 36)
    adj = wind.build_sphere_grid_graph(lat, lon)
    ref = jfeatures(adj, jax.random.PRNGKey(42), walks_per_node=16, p_halt=0.1,
                    max_walk_length=5, method="gather")
    ours = features_for_adjacency(adj, 42, walks_per_node=16, p_halt=0.1, max_walk_length=5,
                                  method="gather", device="cpu")
    np.testing.assert_array_equal(ours.step_matrices.numpy(), np.asarray(ref.step_matrices))


WIND_ARGV = ["--n-lat", "7", "--n-lon", "12", "--walks", "50", "--max-walk-length", "3",
             "--train-steps", "30", "--num-pathwise-samples", "16", "--seeds", "1"]


def test_wind_cli_records_have_the_jax_keys(tmp_path):
    from graphgp_tpu.cli import wind as jwind

    ours = wind.main([*WIND_ARGV, "--device", "cpu", "--results-dir", str(tmp_path / "p")])
    ref = jwind.main(["--n-lat", "7", "--n-lon", "12", "--walks", "50", "--max-walk-length", "3",
                      "--train-steps", "2", "--num-pathwise-samples", "4", "--seeds", "1",
                      "--results-dir", str(tmp_path / "j")])
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref]
    assert [(r["kernel"], r["walks_per_node"]) for r in ours] == [("free", 50), ("diffusion", 50)]
    assert all(np.isfinite(r["rmse"]) and np.isfinite(r["nlpd"]) for r in ours)
    assert (tmp_path / "p" / "wind.csv").exists()


def _write_csr_npz(path, adj, y, extra):
    import scipy.sparse as sp

    a = sp.csr_matrix(adj)
    np.savez(path, A_data=a.data, A_indices=a.indices, A_indptr=a.indptr,
             A_shape=np.asarray(a.shape), X=np.arange(a.shape[0]), y=y, **extra)


@pytest.mark.parametrize("source", ["X_train", "coord_mapping", "random"])
def test_wind_npz_picks_the_training_set_in_order(tmp_path, capsys, source):
    lat, lon = _grid(7, 12)
    adj = wind.build_sphere_grid_graph(lat, lon)
    y = wind.synthetic_wind_speed(lat, lon)
    lat_g, lon_g = (g.ravel() for g in np.meshgrid(lat, lon, indexing="ij"))
    track = np.arange(0, 84, 3, dtype=np.int32)
    extra = {"X_train": track, "coord_mapping": np.stack([lat_g, lon_g], 1)}
    if source != "X_train":
        del extra["X_train"]
    if source == "random":
        del extra["coord_mapping"]
    path = tmp_path / "wind.npz"
    _write_csr_npz(path, adj, y, extra)
    recs = wind.main(["--wind-npz", str(path), "--walks", "40", "--max-walk-length", "3",
                      "--train-steps", "5", "--num-pathwise-samples", "8", "--seeds", "1",
                      "--kinds", "diffusion", "--device", "cpu", "--results-dir", str(tmp_path)])
    assert all(np.isfinite(r["rmse"]) for r in recs)
    out = capsys.readouterr().out
    expect = {"X_train": ("using saved Aeolus-track training nodes", track.size),
              "coord_mapping": ("orbit track derived from coord_mapping",
                                wind.orbit_track_from_coords(lat_g, lon_g).size),
              "random": ("no track info; random 30% train split", 84 // 3)}[source]
    assert expect[0] in out and f"train (orbit track) {expect[1]}," in out


@pytest.mark.parametrize("n,c,seed", [(200, 3, 0), (400, 4, 1), (2485, 7, 0)])
def test_synthetic_community_graph_equals_jax(n, c, seed):
    from graphgp_tpu.cli import classification as jclass

    a, labels = classification.synthetic_community_graph(n, c, seed)
    ra, rlabels = jclass.synthetic_community_graph(n, c, seed)
    assert (a != ra).nnz == 0 and a.nnz == ra.nnz
    np.testing.assert_array_equal(labels, rlabels)


def _write_cora(d, ids=None):
    """The JAX test's fabricated Cora: two 30-node citation communities and
    two links between them, with optional id renaming."""
    d.mkdir()
    rng = np.random.default_rng(0)
    name = ids or (lambda i: str(i))
    edges = []
    for base in (0, 30):
        for _ in range(120):
            a, b = rng.integers(0, 30, 2)
            if a != b:
                edges.append((base + a, base + b))
    edges += [(0, 30), (5, 40)]
    (d / "cora.cites").write_text("".join(f"{name(a)}\t{name(b)}\n" for a, b in edges))
    (d / "cora.content").write_text("".join(
        f"{name(i)}\tfeat\t{'AI' if i < 30 else 'DB'}\n" for i in range(60)))
    return d


def _write_two_components(d):
    """The JAX data test's fabricated Cora: a 4-cycle and a pair; the pair's
    second node has no content row."""
    d.mkdir()
    (d / "cora.cites").write_text("".join(
        f"{a}\t{b}\n" for a, b in [(1, 2), (2, 3), (3, 4), (4, 1), (10, 11)]))
    (d / "cora.content").write_text("".join(
        f"{p}\tfeat\t{s}\n" for p, s in [(1, "AI"), (2, "ML"), (3, "AI"), (4, "DB"), (10, "AI")]))
    return d


@pytest.mark.parametrize("files", ["integers", "strings", "wide-integers", "two-components"])
def test_load_cora_equals_jax(tmp_path, files):
    from graphgp_tpu.data.database import load_cora as jload

    if files == "two-components":
        d = _write_two_components(tmp_path / "cora")
    else:
        rename = {"integers": None, "strings": lambda i: f"p{i}",
                  "wide-integers": lambda i: str(1000000 + 37 * (59 - i))}[files]
        d = _write_cora(tmp_path / "cora", rename)
    for seed, sizes in ((0, {}), (3, {"num_train": 2, "num_test": 2})):
        ours, ref = tdb.load_cora(str(d), seed=seed, **sizes), jload(str(d), seed=seed, **sizes)
        assert (ours[0] != ref[0]).nnz == 0 and ours[0].shape == ref[0].shape
        for o, r in zip(ours[1:], ref[1:]):
            np.testing.assert_array_equal(o, r)
            assert o.dtype == r.dtype


def test_load_cora_graphml_equals_jax(tmp_path):
    from graphgp_tpu.data.database import load_cora as jload
    from graphgp_tpu.data.database import load_cora_graphml as jload_graphml

    d = tmp_path / "cora"
    d.mkdir()
    ns = "http://graphml.graphdrawing.org/xmlns"
    nodes = "".join(f'<node id="n{i}"><data key="d0">{float(i % 3)}</data></node>'
                    for i in range(12))
    edges = "".join(f'<edge source="n{i}" target="n{(i + 1) % 12}" />' for i in range(12))
    edges += '<edge source="n4" target="n4" /><edge source="n0" target="n6" />'
    (d / "cora_result.graphml").write_text(
        f'<?xml version="1.0" encoding="utf-8"?><graphml xmlns="{ns}">'
        f'<key id="d0" for="node" attr.name="ground_truth" attr.type="float" />'
        f'<graph edgedefault="undirected">{nodes}{edges}</graph></graphml>')
    (d / "cora.cites").write_text("0\t1\n")  # ignored: no cora.content beside it
    path = str(d / "cora_result.graphml")
    for ours, ref in ((tdb.load_cora(str(d), seed=2), jload(str(d), seed=2)),
                      (tdb.load_cora_graphml(path, 6, 3, 1), jload_graphml(path, 6, 3, 1))):
        assert (ours[0] != ref[0]).nnz == 0 and ours[0].nnz == 26
        for o, r in zip(ours[1:], ref[1:]):
            np.testing.assert_array_equal(o, r)
    (d / "bad.graphml").write_text(f'<graphml xmlns="{ns}"><graph /></graphml>')
    with pytest.raises(ValueError, match="ground_truth"):
        tdb.load_cora_graphml(str(d / "bad.graphml"))


@pytest.mark.parametrize("kind", ["free", "exact_diffusion"])
def test_classification_cli_beats_chance(tmp_path, kind):
    recs = classification.main([
        "--n-nodes", "200", "--num-classes", "3", "--walks-per-node", "200",
        "--max-walk-length", "3", "--num-steps", "200", "--seeds", "1", "--kernel-kind", kind,
        "--device", "cpu", "--results-dir", str(tmp_path)])
    assert len(recs) == 1 and recs[0]["accuracy"] > 0.5
    assert recs[0]["n_train"] == 160 and recs[0]["num_inducing"] == 80
    assert np.isfinite(recs[0]["test_nll"]) and np.isfinite(recs[0]["final_elbo"])
    assert (tmp_path / "classification.csv").exists()


def test_classification_cli_on_cora_files(tmp_path):
    d = _write_cora(tmp_path / "cora")
    recs = classification.main([
        "--cora-dir", str(d), "--walks-per-node", "100", "--max-walk-length", "3",
        "--num-steps", "150", "--seeds", "1", "--device", "cpu", "--results-dir", str(tmp_path)])
    assert recs[0]["accuracy"] > 0.6
    assert (recs[0]["n_train"], recs[0]["n_test"]) == (48, 12)  # the 80/20 fallback


def test_classification_record_keys_and_split_equal_jax(tmp_path, capsys):
    """The records' keys, the fixed split (seed 1) and the inducing nodes per
    seed, at a depth of 2 steps."""
    from graphgp_tpu.cli import classification as jclass

    argv = ["--n-nodes", "120", "--num-classes", "3", "--walks-per-node", "20",
            "--max-walk-length", "3", "--num-steps", "2", "--seeds", "2", "--num-test", "30"]
    ours = classification.main([*argv, "--device", "cpu", "--results-dir", str(tmp_path / "p")])
    ref = jclass.main([*argv, "--results-dir", str(tmp_path / "j")])
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref]
    for o, r in zip(ours, ref):
        for k in ("n_train", "n_test", "num_inducing", "kernel", "likelihood", "seed"):
            assert o[k] == r[k], k


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def k4_counter():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from graphgp_tpu_torch.cuda_kernels import walker as k4

    k4.launches = 0
    return k4


@pytest.mark.gpu
def test_wind_cli_on_the_card_launches_k4(tmp_path, k4_counter):
    recs = wind.main([*WIND_ARGV, "--walks", "50", "200", "--device", "cuda",
                      "--results-dir", str(tmp_path)])
    assert k4_counter.launches == 2
    assert all(np.isfinite(r["rmse"]) and np.isfinite(r["nlpd"]) for r in recs)


@pytest.mark.gpu
def test_classification_cli_on_the_card_launches_k4(tmp_path, k4_counter):
    recs = classification.main([
        "--n-nodes", "200", "--num-classes", "3", "--walks-per-node", "200",
        "--max-walk-length", "3", "--num-steps", "200", "--seeds", "1", "--device", "cuda",
        "--results-dir", str(tmp_path)])
    assert k4_counter.launches == 1
    assert recs[0]["accuracy"] > 0.5
