"""Real-dataset loader with a memory and a disk cache.

Counterpart of ``graphgp_tpu/data/database.py`` (``edges_to_csr``,
``_degree_targets``, the edge-list readers, ``_load_csr_npz`` and
``GraphDataLoader``), with the JAX registry's names and file paths, reading
with the ``csv`` module and numpy (no pandas). A dataset is read from its
cache ``<cache_dir>/<name>.npz`` (the reference's npz layout of CSR triplets
``A_data``, ``A_indices``, ``A_indptr``, ``A_shape`` with node ids ``X`` and
targets ``y``, as the shipped ``processed_data/facebook.npz`` and
``processed_data/pems_bay.npz`` hold them) when it is there; otherwise from
its raw file under ``data_root``, which is then cached. Nothing is
downloaded: a missing raw file raises, naming the path it expected.
``load_cora`` reads ``cora.cites`` / ``cora.content`` with the ``csv``
module, typing each column as pandas infers it (so nodes order as in the
JAX package), and ``load_cora_graphml`` reads the labelled GraphML export
with ``xml.etree``.
"""
from __future__ import annotations

import csv
import gzip
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp

Arrays = Tuple[sp.csr_matrix, np.ndarray, np.ndarray]


def edges_to_csr(u: np.ndarray, v: np.ndarray) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Undirected simple graph from raw edge endpoint arrays: node ids
    dense-ranked (original ids → 0..N-1 in sorted order), self-loops dropped,
    multi-edges collapsed to weight 1. Returns (adjacency, original node ids)."""
    uv = np.stack([np.asarray(u), np.asarray(v)])
    nodes, flat = np.unique(uv, return_inverse=True)
    ui, vi = flat.reshape(2, -1)
    keep = ui != vi
    ui, vi = ui[keep], vi[keep]
    n = nodes.size
    adj = sp.coo_matrix(
        (np.ones(ui.size * 2), (np.concatenate([ui, vi]), np.concatenate([vi, ui]))),
        shape=(n, n),
    ).tocsr()
    adj.data[:] = 1.0
    return adj, nodes


def _degree_targets(adj: sp.csr_matrix) -> np.ndarray:
    """Social-network target: the node's degree."""
    return np.asarray(adj.sum(axis=1)).ravel().astype(np.float32)


def _read_csv_columns(path: str, names) -> Dict[str, np.ndarray]:
    """Named columns of a CSV file with a header row, as float64 arrays."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        ix = [header.index(name) for name in names]
        rows = [[row[i] for i in ix] for row in reader if row]
    table = np.asarray(rows, dtype=np.float64).reshape(-1, len(names))
    return {name: table[:, k] for k, name in enumerate(names)}


def _load_edge_csv(path: str, src_col: str, dst_col: str) -> Arrays:
    cols = _read_csv_columns(path, (src_col, dst_col))
    adj, _ = edges_to_csr(cols[src_col].astype(np.int64), cols[dst_col].astype(np.int64))
    return adj, np.arange(adj.shape[0]), _degree_targets(adj)


def _load_edge_txt_gz(path: str) -> Arrays:
    us, vs = [], []
    with gzip.open(path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            a, b = line.split()
            us.append(int(a))
            vs.append(int(b))
    adj, _ = edges_to_csr(np.asarray(us), np.asarray(vs))
    return adj, np.arange(adj.shape[0]), _degree_targets(adj)


def _load_pems_bay_distances(path: str) -> Arrays:
    """The PEMS-BAY sensor graph from its road-distance table (sensor_from,
    sensor_to, metres; no header): DCRNN-style weights ``exp(−(d/σ)²)``, σ
    the distances' std, thresholded at 0.1 and symmetrized; the target is a
    seeded sample of the exact diffusion kernel (β = 5) on that graph, as
    the JAX package builds it."""
    with open(path, newline="") as fh:
        table = np.asarray([row for row in csv.reader(fh) if row], dtype=np.float64)
    u, v, dist = table[:, 0].astype(np.int64), table[:, 1].astype(np.int64), table[:, 2]
    keep = (u != v) & (dist > 0)
    u, v, dist = u[keep], v[keep], dist[keep]
    ids = np.unique(np.concatenate([u, v]))
    rows, cols = np.searchsorted(ids, u), np.searchsorted(ids, v)
    sigma = dist.std()
    w = np.exp(-((dist / sigma) ** 2))
    keep = w >= 0.1
    n = ids.size
    adj = sp.coo_matrix((w[keep], (rows[keep], cols[keep])), shape=(n, n))
    adj = adj.tocsr().maximum(adj.T.tocsr())

    dense = adj.toarray()
    deg = dense.sum(axis=1)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.where(deg > 0, deg, 1.0)), 0.0)
    lap = np.eye(n) - dense * dinv[:, None] * dinv[None, :]
    evals, evecs = np.linalg.eigh(lap)
    k = (evecs * np.exp(-5.0 * evals)) @ evecs.T
    rng = np.random.default_rng(7)
    chol = np.linalg.cholesky(k + 1e-8 * np.eye(n))
    y = chol @ rng.normal(size=n)
    return adj.tocsr(), ids.astype(np.int64), y.astype(np.float32)


def _load_csr_npz(path: str) -> Arrays:
    """(adjacency CSR, node ids, targets) from a CSR-triplet npz."""
    with np.load(path) as data:
        adj = sp.csr_matrix(
            (data["A_data"], data["A_indices"], data["A_indptr"]),
            shape=tuple(int(d) for d in data["A_shape"]),
        )
        return adj, np.asarray(data["X"]), np.asarray(data["y"])


class GraphDataLoader:
    """Callable: ``loader(name) -> {'adjacency', 'node_ids', 'y_observed',
    'y_true'}``.

    ``data_root`` (or the ``GRAPHGP_DATA_ROOT`` variable, or a ``raw_data``
    directory in the working directory) must name an existing directory: it
    holds the raw files (``social_networks/``, ``wind_interpolation/``,
    ``synthetic/``). A dataset whose cache ``<cache_dir>/<name>.npz`` exists
    is read from there and nothing else.
    """

    _DEFAULT_ROOTS = ("raw_data",)

    def __init__(self, data_root: Optional[str] = None, cache_dir: Optional[str] = None):
        if data_root is None:
            data_root = os.environ.get("GRAPHGP_DATA_ROOT")
        if data_root is None:
            data_root = next((r for r in self._DEFAULT_ROOTS if os.path.isdir(r)), None)
            if data_root is None:
                raise FileNotFoundError(
                    f"no dataset root found: none of {list(self._DEFAULT_ROOTS)} exists. Set "
                    "the GRAPHGP_DATA_ROOT environment variable (or pass data_root=) to the "
                    "directory holding the raw dataset tree (social_networks/, "
                    "wind_interpolation/, synthetic/)."
                )
        self.data_root = data_root
        self.cache_dir = cache_dir or "processed_data"
        self._memory_cache: Dict[str, Dict] = {}
        os.makedirs(self.cache_dir, exist_ok=True)

        self.registry: Dict[str, Tuple[str, Callable[[str], Arrays]]] = {
            "facebook": (
                "social_networks/facebook/facebook_large/musae_facebook_edges.csv",
                lambda p: _load_edge_csv(p, "id_1", "id_2"),
            ),
            "twitch": (
                "social_networks/twitch/large_twitch_edges.csv",
                lambda p: _load_edge_csv(p, "numeric_id_1", "numeric_id_2"),
            ),
            "youtube": ("social_networks/youtube/com-youtube.ungraph.txt.gz", _load_edge_txt_gz),
            "enron": ("social_networks/enron/email-Enron.txt.gz", _load_edge_txt_gz),
            "pems_bay": (
                "../../../dense/traffic_dataset/data/PEMS/distances_bay_2017.csv",
                _load_pems_bay_distances,
            ),
        }
        for level in ["500hpa", "800hpa", "1000hpa"]:
            for wide in ["", "_wide"]:
                sub = level.replace("hpa", "hPa") + wide
                self.registry[level + wide] = (
                    f"wind_interpolation/{sub}/wind_data_processed_{sub}.npz",
                    _load_csr_npz,
                )
        for name, sub, fname in [
            ("single_modal", "single_modal", "synthetic_single_modal_1000x1000.npz"),
            ("multi_modal", "multi-modal", "synthetic_multimodal_1000x1000.npz"),
            ("bimodal", "bimodal", "synthetic_bimodal_100x100.npz"),
            ("community", "community", "synthetic_community_10k.npz"),
            ("circular", "circular", "synthetic_circular_10k.npz"),
        ]:
            self.registry[name] = (f"synthetic/{sub}/{fname}", _load_csr_npz)

    def available(self):
        return sorted(self.registry)

    def _cache_path(self, name: str) -> str:
        return os.path.join(self.cache_dir, f"{name}.npz")

    def __call__(self, name: str, force_reload: bool = False) -> Dict:
        if name not in self.registry:
            raise ValueError(f"unknown dataset {name!r}; available: {self.available()}")
        if not force_reload and name in self._memory_cache:
            return self._memory_cache[name]

        cache_path = self._cache_path(name)
        if not force_reload and os.path.exists(cache_path):
            adj, node_ids, y = _load_csr_npz(cache_path)
        else:
            rel, loader = self.registry[name]
            path = os.path.join(self.data_root, rel)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"dataset file for {name!r} not found: {path}; nothing is downloaded, "
                    "place the raw file there"
                )
            adj, node_ids, y = loader(path)
            np.savez_compressed(
                cache_path,
                A_data=adj.data,
                A_indices=adj.indices,
                A_indptr=adj.indptr,
                A_shape=np.asarray(adj.shape),
                X=node_ids,
                y=y,
            )

        out = {
            "adjacency": adj,
            "node_ids": np.asarray(node_ids),
            "y_observed": np.asarray(y, dtype=np.float32),
            "y_true": np.asarray(y, dtype=np.float32),
        }
        self._memory_cache[name] = out
        return out


def _split(n: int, num_train: int, num_test: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Random train / test node ids (sorted) from ``default_rng(seed)``; an
    80/20 split of what is there when the graph is smaller than asked."""
    if num_train + num_test > n:
        num_train = min(num_train, int(n * 0.8))
        num_test = n - num_train
    perm = np.random.default_rng(seed).permutation(n)
    train_idx = np.sort(perm[:num_train]).astype(np.int32)
    test_idx = np.sort(perm[num_train : num_train + num_test]).astype(np.int32)
    return train_idx, test_idx


def load_cora_graphml(path: str, num_train: int = 1988, num_test: int = 497, seed: int = 0):
    """Cora's largest connected component from a GraphML export whose nodes
    carry a ``ground_truth`` label (the reference's ``cora_result.graphml``).
    Returns (adjacency_csr, labels, train_idx, test_idx)."""
    import xml.etree.ElementTree as ET

    ns = {"g": "http://graphml.graphdrawing.org/xmlns"}
    root = ET.parse(path).getroot()
    label_key = None
    for k in root.findall("g:key", ns):
        if k.get("attr.name") == "ground_truth":
            label_key = k.get("id")
    if label_key is None:
        raise ValueError(f"{path}: no 'ground_truth' node attribute")
    graph = root.find("g:graph", ns)
    ids, raw_labels = [], []
    for nd in graph.findall("g:node", ns):
        ids.append(nd.get("id"))
        val = np.nan
        for d in nd.findall("g:data", ns):
            if d.get("key") == label_key:
                val = float(d.text)
        raw_labels.append(val)
    id_map = {s: i for i, s in enumerate(ids)}
    n = len(ids)
    us = np.asarray([id_map[e.get("source")] for e in graph.findall("g:edge", ns)], np.int64)
    vs = np.asarray([id_map[e.get("target")] for e in graph.findall("g:edge", ns)], np.int64)
    keep = us != vs
    us, vs = us[keep], vs[keep]
    adj = sp.coo_matrix(
        (np.ones(us.size * 2), (np.concatenate([us, vs]), np.concatenate([vs, us]))),
        shape=(n, n),
    ).tocsr()
    adj.data[:] = 1.0
    classes = {v: i for i, v in enumerate(sorted(set(raw_labels)))}
    labels = np.asarray([classes[v] for v in raw_labels], np.int32)
    return (adj, labels, *_split(n, num_train, num_test, seed))


def _typed_column(values):
    """A text column typed as pandas' ``read_csv`` infers it: int64 when every
    entry is an integer, else float64 when every entry is a number, else
    the strings."""
    for kind in (int, float):
        try:
            return np.asarray([kind(v) for v in values])
        except ValueError:
            continue
    return np.asarray(values, dtype=object)


def _read_tsv(path: str):
    with open(path, newline="") as fh:
        return [row for row in csv.reader(fh, delimiter="\t") if row]


def load_cora(data_dir: str, num_train: int = 1988, num_test: int = 497, seed: int = 0):
    """Cora citation graph: its largest connected component, 7-class labels
    (the reference's ``load_cora``), from ``cora.cites`` (cited, citing) and
    ``cora.content`` (id, features..., subject) under ``data_dir``. Without
    ``cora.content`` but with a labelled ``cora_result.graphml`` there, reads
    that instead (:func:`load_cora_graphml`). Nodes of the component with no
    content row get class 0, as in the JAX package. Returns (adjacency_csr,
    labels, train_idx, test_idx)."""
    content_path = os.path.join(data_dir, "cora.content")
    graphml_path = os.path.join(data_dir, "cora_result.graphml")
    if not os.path.exists(content_path) and os.path.exists(graphml_path):
        return load_cora_graphml(graphml_path, num_train, num_test, seed)

    cites = _read_tsv(os.path.join(data_dir, "cora.cites"))
    target = _typed_column([r[0] for r in cites])
    source = _typed_column([r[1] for r in cites])
    adj_all, nodes = edges_to_csr(source, target)

    _, comp = sp.csgraph.connected_components(adj_all, directed=False)
    keep = np.flatnonzero(comp == np.argmax(np.bincount(comp)))
    adj = adj_all[keep][:, keep].tocsr()
    kept_nodes = nodes[keep]

    content = _read_tsv(content_path)
    index = _typed_column([r[0] for r in content])
    subjects = _typed_column([r[-1] for r in content])
    classes = {c: i for i, c in enumerate(sorted(set(subjects.tolist())))}
    subject_by_node = dict(zip(index.tolist(), subjects.tolist()))
    labels = np.zeros(keep.size, dtype=np.int32)
    for i, node in enumerate(kept_nodes.tolist()):
        if node in subject_by_node:
            labels[i] = classes[subject_by_node[node]]
    return (adj, labels, *_split(keep.size, num_train, num_test, seed))
