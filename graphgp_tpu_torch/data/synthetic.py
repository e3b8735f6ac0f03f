"""Synthetic graph + field generators for scaling and BO experiments (a copy
of graphgp_tpu/data/synthetic.py: numpy and scipy only).

Functional ports of the reference's generator semantics (not code): ring
graphs from the scaling experiment (reference
experiments/sparse/scaling_exp/run_scaling_experiment.py:154-198) and the
five BO surfaces (reference experiments/sparse/scalable_bo/bo_utils/
data_utils.py:20-262: grid central-bump, periodic torus, staircase, circle,
grid multimodal), and a random geometric graph (the 10th DIMACS
Implementation Challenge's ``rgg_n_2_*`` construction). All return
``{'adjacency': scipy CSR, 'y_true': (N,), 'y_observed': (N,), 'node_ids': (N,)}``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp


def _grid_adjacency(s: int) -> sp.csr_matrix:
    """4-neighbor s×s grid via Kronecker products (reference
    data_utils.py:56-60)."""
    e = np.ones(s)
    t = sp.diags([e[:-1], e[:-1]], offsets=[-1, 1], shape=(s, s), format="csr")
    eye = sp.eye(s, format="csr")
    return (sp.kron(eye, t, format="csr") + sp.kron(t, eye, format="csr")).tocsr()


def _require_square(n_nodes: int) -> int:
    s = int(np.sqrt(n_nodes))
    if s * s != n_nodes:
        raise ValueError(f"n_nodes must be a perfect square (got {n_nodes})")
    return s


def _pack(adjacency, y_true, y_observed) -> Dict:
    n = y_true.shape[0]
    return {
        "adjacency": adjacency,
        "y_true": y_true.astype(np.float32),
        "y_observed": y_observed.astype(np.float32),
        "node_ids": np.arange(n, dtype=np.int32),
    }


def generate_ring_data(
    n_nodes: int, noise_std: float = 0.1, seed: int = 42
) -> Dict:
    """Ring graph with a smooth two-frequency field (reference scaling
    experiment's ring data, run_scaling_experiment.py:154-198)."""
    rng = np.random.default_rng(seed)
    rows = np.arange(n_nodes)
    cols = (rows + 1) % n_nodes
    adj = sp.csr_matrix((np.ones(n_nodes), (rows, cols)), shape=(n_nodes, n_nodes))
    adj = (adj + adj.T).tocsr()
    angles = 2 * np.pi * np.arange(n_nodes) / n_nodes
    y_true = np.sin(2 * angles) + 0.5 * np.cos(5 * angles)
    return _pack(adj, y_true, y_true + rng.normal(0, noise_std, n_nodes))


def generate_grid_data(
    n_nodes: int, beta_sample: float = 1.0, noise_std: float = 0.1, seed: int = 42
) -> Dict:
    """Central-maximum surface on an s×s grid (reference data_utils.py:20-75)."""
    s = _require_square(n_nodes)
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, s)
    xg, yg = np.meshgrid(x, x)
    y_true = _bump_surface(xg, yg, beta_sample).reshape(-1)
    return _pack(
        _grid_adjacency(s), y_true, y_true + rng.normal(0, noise_std, n_nodes)
    )


def _bump_surface(x: np.ndarray, y: np.ndarray, beta_sample: float = 1.0) -> np.ndarray:
    """The flagship's central-maximum surface at points (x, y) of the unit
    square (reference data_utils.py:20-75)."""
    base = 1.2 * np.sin(2 * np.pi * x) + 0.6 * np.cos(3 * np.pi * y)
    bump = 3 * np.exp(-0.5 * (((x - 0.5) / 0.06) ** 2 + ((y - 0.5) / 0.06) ** 2))
    return beta_sample * (base + bump)


def rgg_radius(n_nodes: int, radius_scale: float = 0.55) -> float:
    """The DIMACS10 random geometric graph's radius, ``radius_scale ·
    √(ln n / n)`` (Holtgrewe, Sanders and Schulz, IPDPS 2010)."""
    return radius_scale * float(np.sqrt(np.log(n_nodes) / n_nodes))


def generate_rgg_data(
    n_nodes: int, radius_scale: float = 0.55, noise_std: float = 0.1, seed: int = 42
) -> Dict:
    """Random geometric graph with the flagship's central-bump field.

    ``n_nodes`` points uniform in the unit square, joined by a unit-weight
    edge when closer than :func:`rgg_radius` (no wrap-around, no self-loops),
    the construction of DIMACS10's ``rgg_n_2_20_s0`` at n = 2^20. Node ids
    follow the draw order, so they carry no locality. ``y_true`` is
    :func:`generate_grid_data`'s surface at each point's (x, y)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    pts = rng.random((n_nodes, 2))
    r = rgg_radius(n_nodes, radius_scale)
    # the tree's own distance test may round otherwise: a slightly wider
    # query, then the strict test on squared distances
    pairs = cKDTree(pts).query_pairs(r * (1 + 1e-9), output_type="ndarray")
    d = pts[pairs[:, 0]] - pts[pairs[:, 1]]
    pairs = pairs[d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] < r * r]
    rows = np.concatenate([pairs[:, 0], pairs[:, 1]])
    cols = np.concatenate([pairs[:, 1], pairs[:, 0]])
    adj = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(n_nodes, n_nodes))
    y_true = _bump_surface(pts[:, 0], pts[:, 1])
    return _pack(adj, y_true, y_true + rng.normal(0, noise_std, n_nodes))


def generate_periodic_grid_data(
    n_nodes: int, beta_sample: float = 1.0, noise_std: float = 0.1, seed: int = 42
) -> Dict:
    """Torus grid with a periodic multi-mode field (reference
    data_utils.py:77-131)."""
    s = _require_square(n_nodes)
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    node = (i * s + j).ravel()
    right = (i * s + (j + 1) % s).ravel()
    down = (((i + 1) % s) * s + j).ravel()
    rows = np.concatenate([node, right, node, down])
    cols = np.concatenate([right, node, down, node])
    adj = sp.coo_matrix(
        (np.ones(rows.size), (rows, cols)), shape=(n_nodes, n_nodes)
    ).tocsr()
    x = np.linspace(0, 2 * np.pi, s, endpoint=False)
    xg, yg = np.meshgrid(x, x)
    z = beta_sample * (
        np.sin(xg) * np.cos(yg)
        + 0.5 * np.sin(2 * xg) * np.sin(2 * yg)
        + 0.3 * np.cos(3 * xg + yg)
    )
    y_true = z.reshape(-1)
    return _pack(adj, y_true, y_true + rng.normal(0, noise_std, n_nodes))


def generate_staircase_grid_data(
    n_nodes: int,
    beta_sample: float = 1.0,
    noise_std: float = 0.1,
    seed: int = 42,
    n_levels: int = 5,
) -> Dict:
    """Diagonal staircase/plateau field on a grid (reference
    data_utils.py:133-187)."""
    s = _require_square(n_nodes)
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, s)
    xg, yg = np.meshgrid(x, x)
    diag = xg + yg
    level_width = 2.0 / n_levels
    z = np.zeros_like(xg)
    for level in range(n_levels):
        mask = (diag >= level * level_width) & (diag < (level + 1) * level_width)
        z[mask] = level + rng.uniform(-0.2, 0.2)
    z = beta_sample * (z + 0.3 * np.sin(2 * np.pi * xg) * np.cos(2 * np.pi * yg))
    y_true = z.reshape(-1)
    return _pack(
        _grid_adjacency(s), y_true, y_true + rng.normal(0, noise_std, n_nodes)
    )


def generate_circle_graph_data(
    n_nodes: int, beta_sample: float = 1.0, noise_std: float = 0.1, seed: int = 42
) -> Dict:
    """Cycle graph with a sinusoidal field (reference data_utils.py:189-210)."""
    rng = np.random.default_rng(seed)
    rows = np.arange(n_nodes)
    cols = (rows + 1) % n_nodes
    adj = sp.csr_matrix((np.ones(n_nodes), (rows, cols)), shape=(n_nodes, n_nodes))
    adj = (adj + adj.T).tocsr()
    angles = np.linspace(0, 2 * np.pi, n_nodes, endpoint=False)
    y_true = beta_sample * (
        2 * np.sin(2 * angles) + 0.5 * np.cos(4 * angles) + 0.3 * np.sin(angles)
    )
    return _pack(adj, y_true, y_true + rng.normal(0, noise_std, n_nodes))


def generate_grid_multimodal_data(
    n_nodes: int,
    beta_sample: float = 1.0,
    noise_std: float = 0.1,
    seed: int = 42,
    n_peaks: int = 5,
) -> Dict:
    """Grid with multiple random Gaussian peaks (reference
    data_utils.py:212-262)."""
    s = _require_square(n_nodes)
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, s)
    xg, yg = np.meshgrid(x, x)
    z = 0.5 * np.sin(2 * np.pi * xg) + 0.3 * np.cos(3 * np.pi * yg)
    for _ in range(n_peaks):
        cx, cy = rng.uniform(0.1, 0.9, size=2)
        amp = rng.uniform(1.0, 3.0)
        wx, wy = rng.uniform(0.05, 0.15, size=2)
        z = z + amp * np.exp(-0.5 * (((xg - cx) / wx) ** 2 + ((yg - cy) / wy) ** 2))
    y_true = (beta_sample * z).reshape(-1)
    return _pack(
        _grid_adjacency(s), y_true, y_true + rng.normal(0, noise_std, n_nodes)
    )


def generate_pems_like_data(
    n_nodes: int = 0,
    n_sensors: int = 325,
    n_junctions: int = 64,
    noise_std: float = 1.0,
    seed: int = 42,
) -> Dict:
    """Offline stand-in for the reference's PEMS-Bay highway sensor graph.

    The reference builds it from OSMnx motorways with sensors spliced into
    edge geometry and edge weight = mean_length/length (reference
    experiments/dense/traffic_dataset/traffic_utils/preprocessing.py:83-182);
    that needs network downloads. This generator reproduces the *statistics*
    of that construction with no I/O:

      * junction skeleton: random planar points wired by a Euclidean
        spanning tree + nearest-neighbor shortcuts (degree mostly 2-4, like
        a pruned motorway network);
      * corridors: each skeleton link subdivided into road segments with
        jittered lengths (chains of degree-2 nodes);
      * sensors: length-weighted random edges cut in two, the sensor
        inserted as a degree-2 node (exactly the reference's splice);
      * weights: mean_length / length over the final edge set;
      * targets: traffic speeds — a smooth base field with congestion
        pockets, evaluated at every node, observed at sensors with noise.

    ``n_nodes`` is accepted for GENERATORS-signature compatibility and
    ignored (the node count is determined by the construction, ~junctions +
    segments + sensors ≈ 700-900 for the defaults, matching the reference's
    scale).

    Returns the standard dict plus ``sensor_nodes`` — the node ids carrying
    observations; the traffic protocol trains/tests ONLY on these.
    """
    del n_nodes
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, size=(n_junctions, 2))

    # --- skeleton: Euclidean MST (Prim) + k-nearest shortcut edges
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    in_tree = np.zeros(n_junctions, bool)
    in_tree[0] = True
    best = d2[0].copy()
    best_from = np.zeros(n_junctions, np.int64)
    links = set()
    for _ in range(n_junctions - 1):
        j = int(np.argmin(np.where(in_tree, np.inf, best)))
        links.add((min(int(best_from[j]), j), max(int(best_from[j]), j)))
        in_tree[j] = True
        closer = d2[j] < best
        best = np.where(closer, d2[j], best)
        best_from = np.where(closer, j, best_from)
    n_shortcuts = n_junctions // 4  # ring roads / parallel corridors
    for j in rng.choice(n_junctions, size=n_shortcuts, replace=False):
        k = int(np.argsort(d2[j])[1])  # 2nd-nearest (nearest is in the MST)
        links.add((min(j, int(k)), max(j, int(k))))

    # --- corridors: subdivide each link into 1-5 road segments
    coords = [tuple(p) for p in pts]
    edges = {}  # (u, v) -> length

    def add_edge(u, v, length):
        key = (min(u, v), max(u, v))
        edges[key] = float(length)

    for (u, v) in sorted(links):
        n_seg = 1 + int(rng.poisson(2.0))
        span = np.sqrt(d2[u, v]) if np.isfinite(d2[u, v]) else 0.05
        prev = u
        for s in range(1, n_seg):
            t = s / n_seg
            mid = (1 - t) * pts[u] + t * pts[v]
            mid = mid + rng.normal(0, 0.004, 2)  # road curvature
            coords.append(tuple(mid))
            node = len(coords) - 1
            add_edge(prev, node, span / n_seg * rng.uniform(0.7, 1.4))
            prev = node
        add_edge(prev, v, span / n_seg * rng.uniform(0.7, 1.4))

    # --- sensor splices: cut length-weighted random edges
    sensor_nodes = []
    for _ in range(n_sensors):
        keys = list(edges.keys())
        lengths = np.asarray([edges[k] for k in keys])
        pick = keys[int(rng.choice(len(keys), p=lengths / lengths.sum()))]
        u, v = pick
        length = edges.pop(pick)
        t = rng.uniform(0.15, 0.85)
        mid = (1 - t) * np.asarray(coords[u]) + t * np.asarray(coords[v])
        coords.append(tuple(mid))
        node = len(coords) - 1
        add_edge(u, node, t * length)
        add_edge(node, v, (1 - t) * length)
        sensor_nodes.append(node)

    n = len(coords)
    xy = np.asarray(coords, np.float64)
    keys = list(edges.keys())
    lengths = np.asarray([edges[k] for k in keys])
    weights = lengths.mean() / lengths  # the reference's weight convention
    rows = np.asarray([k[0] for k in keys])
    cols = np.asarray([k[1] for k in keys])
    import scipy.sparse as sp

    adj = sp.csr_matrix((weights, (rows, cols)), shape=(n, n))
    adj = adj + adj.T

    # --- speed field: free-flow base minus congestion pockets
    centers = rng.uniform(0.1, 0.9, size=(4, 2))
    depth = rng.uniform(15.0, 30.0, size=4)
    width = rng.uniform(0.05, 0.15, size=4)
    y_true = np.full(n, 65.0)
    for c, dph, w in zip(centers, depth, width):
        y_true -= dph * np.exp(-((xy - c) ** 2).sum(-1) / (2 * w * w))
    y_observed = y_true + rng.normal(0, noise_std, n)
    out = _pack(adj, y_true.astype(np.float32), y_observed.astype(np.float32))
    out["sensor_nodes"] = np.asarray(sorted(sensor_nodes), np.int32)
    out["coords"] = xy.astype(np.float32)
    return out


GENERATORS = {
    "ring": generate_ring_data,
    "grid": generate_grid_data,
    "periodic_grid": generate_periodic_grid_data,
    "staircase_grid": generate_staircase_grid_data,
    "circle": generate_circle_graph_data,
    "grid_multimodal": generate_grid_multimodal_data,
    "pems_like": generate_pems_like_data,
    "rgg": generate_rgg_data,
}


def generate(graph_type: str, n_nodes: int, **kwargs) -> Dict:
    if graph_type not in GENERATORS:
        raise ValueError(
            f"unknown graph_type {graph_type!r}; options: {sorted(GENERATORS)}"
        )
    return GENERATORS[graph_type](n_nodes, **kwargs)
