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
downloaded: a missing raw file raises, naming the path it expected. The Cora
loaders are not ported yet.
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
