"""Plotting helpers: network layouts and GP fit visualizations.

Counterpart of ``graphgp_tpu/utils/plotting.py`` (the reference's
``plot_network_graph`` and ``plot_gp_fit``), matplotlib-based. matplotlib
and networkx are imported inside the functions, so nothing else of the
package needs them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _numpy(x) -> np.ndarray:
    """Tensors (on any device) and array-likes as numpy arrays."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def plot_network_graph(adjacency, values=None, ax=None, node_size: int = 30):
    """Spring-layout scatter of the graph, optionally colored by node values."""
    import matplotlib.pyplot as plt
    import networkx as nx
    import scipy.sparse as sp

    g = (
        nx.from_scipy_sparse_array(adjacency)
        if sp.issparse(adjacency)
        else nx.from_numpy_array(_numpy(adjacency))
    )
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    pos = nx.spring_layout(g, seed=42)
    nx.draw_networkx_edges(g, pos, ax=ax, alpha=0.3)
    nx.draw_networkx_nodes(
        g, pos, ax=ax, node_size=node_size,
        node_color=_numpy(values) if values is not None else "C0",
        cmap="viridis",
    )
    ax.set_axis_off()
    return ax


def plot_gp_fit(
    train_idx,
    y_train,
    test_idx,
    mean,
    var,
    y_true: Optional[np.ndarray] = None,
    ax=None,
):
    """1-D GP fit plot over node index: mean ± 2σ band, observations, truth."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    test_idx = _numpy(test_idx)
    order = np.argsort(test_idx)
    ti, m = test_idx[order], _numpy(mean)[order]
    s = np.sqrt(_numpy(var)[order])
    ax.plot(ti, m, "C0-", label="posterior mean")
    ax.fill_between(ti, m - 2 * s, m + 2 * s, color="C0", alpha=0.2, label="±2σ")
    ax.plot(_numpy(train_idx), _numpy(y_train), "k.", ms=4, label="observed")
    if y_true is not None:
        y_true = _numpy(y_true)
        ax.plot(np.arange(len(y_true)), y_true, "C3--", lw=1, label="truth")
    ax.set_xlabel("node index")
    ax.legend(loc="best", fontsize=8)
    return ax
