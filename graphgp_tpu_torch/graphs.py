"""Graph packing: the normalized Laplacian as a neighbour table.

Counterpart of ``graphgp_tpu/graphs.py``. The walk engine reads either
fixed-width ELL ``neighbors`` / ``weights`` rows padded to the largest row
degree (:class:`PackedGraph`), or, for skewed degree distributions whose ELL
padding would waste more than 4x the edges, the exact nonzeros in CSR order
(:class:`CsrGraph`). Either way every walk step is a few gathers. Packing runs
on the host (numpy / scipy); ``.to(device)`` moves the tables to the device
that walks them.

``L = I - D^{-1/2} A D^{-1/2}`` with zero-degree rows guarded, as the JAX
package builds it. Sparse inputs (every synthetic BO graph) go through numpy
float64 in both packages and give bit-identical tables; a dense input's
weights may differ by up to two ulps, because XLA's CPU float32 rsqrt is not
correctly rounded and torch's is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .linalg import safe_cholesky


def normalized_laplacian_csr(adj_csr) -> sp.csr_matrix:
    """Sparse (scipy CSR) normalized Laplacian, host-side."""
    adj_csr = adj_csr.tocsr()
    deg = np.asarray(adj_csr.sum(axis=1)).ravel()
    inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.where(deg > 0, deg, 1.0)), 0.0)
    d = sp.diags(inv_sqrt)
    lap = sp.eye(adj_csr.shape[0], format="csr") - d @ adj_csr @ d
    lap.eliminate_zeros()
    return lap.tocsr()


def normalized_laplacian(adj) -> torch.Tensor:
    """Dense symmetric-normalized Laplacian ``I - D^{-1/2} A D^{-1/2}`` in
    float32, on the device of ``adj`` (array-likes land on the CPU), computed
    as the JAX package computes it: rsqrt of the float32 degree, then two
    float32 scalings. A zero-degree row gets a zero inverse-sqrt degree, which
    leaves an isolated unit self-loop. Entries may differ from the JAX
    package's by up to two ulps of the off-diagonal weight: XLA's CPU float32
    rsqrt is not correctly rounded, torch's is."""
    if not isinstance(adj, torch.Tensor):
        adj = torch.from_numpy(np.asarray(adj, dtype=np.float32))
    adj = adj.to(torch.float32)
    deg = adj.sum(dim=1)
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(torch.where(deg > 0, deg, 1.0)), 0.0)
    norm = adj * inv_sqrt[:, None] * inv_sqrt[None, :]
    return torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device) - norm



def laplacian(adj) -> torch.Tensor:
    """Unnormalized Laplacian ``D - A`` in float32, on the device of ``adj``
    (array-likes land on the CPU)."""
    if not isinstance(adj, torch.Tensor):
        adj = torch.from_numpy(np.asarray(adj, dtype=np.float32))
    adj = adj.to(torch.float32)
    return torch.diag(adj.sum(dim=1)) - adj

@dataclasses.dataclass(frozen=True)
class PackedGraph:
    """ELL-packed weighted graph.

    neighbors: int32 (N, D), column ids of row i's nonzeros, padded with i.
    weights: float32 (N, D), matching weights, padded with 0.
    degree: int32 (N,), true nonzero count of each row.
    """

    neighbors: torch.Tensor
    weights: torch.Tensor
    degree: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.neighbors.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.neighbors.device

    def to(self, device) -> "PackedGraph":
        return PackedGraph(
            self.neighbors.to(device), self.weights.to(device), self.degree.to(device)
        )


@dataclasses.dataclass(frozen=True)
class CsrGraph:
    """CSR-packed weighted graph for skewed degree distributions: exactly nnz
    edges, where ELL would pad every row to the largest degree.

    node_table: int32 (N, 2), ``[row_start, degree]`` of each node.
    neighbors: int32 (nnz,), column ids in row order.
    weights: float32 (nnz,), matching weights.

    The JAX package stores the neighbour ids as float32 in one (nnz, 2) edge
    table (exact below 2^24 nodes); here they stay int32, the same walk.
    """

    node_table: torch.Tensor
    neighbors: torch.Tensor
    weights: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.node_table.shape[0]

    @property
    def nnz(self) -> int:
        return self.neighbors.shape[0]

    @property
    def degree(self) -> torch.Tensor:
        return self.node_table[:, 1]

    @property
    def device(self) -> torch.device:
        return self.node_table.device

    def to(self, device) -> "CsrGraph":
        return CsrGraph(
            self.node_table.to(device), self.neighbors.to(device), self.weights.to(device)
        )


def csr_graph(csr) -> CsrGraph:
    """Build a CsrGraph from a scipy CSR matrix (host-side)."""
    csr = csr.tocsr()
    csr.eliminate_zeros()
    n = csr.shape[0]
    if n >= (1 << 24):
        raise ValueError(
            "CsrGraph keeps the JAX package's limit of 2^24 nodes (its edge table "
            f"holds neighbour ids as float32); got {n} nodes"
        )
    indptr = np.asarray(csr.indptr)
    deg = np.diff(indptr).astype(np.int32)
    node_table = np.stack([indptr[:-1].astype(np.int32), deg], axis=1)
    return CsrGraph(
        torch.from_numpy(node_table),
        torch.from_numpy(csr.indices.astype(np.int32)),
        torch.from_numpy(csr.data.astype(np.float32)),
    )


def _packed(neighbors, weights, deg) -> PackedGraph:
    return PackedGraph(
        torch.from_numpy(neighbors), torch.from_numpy(weights), torch.from_numpy(deg)
    )


def pack_dense(matrix: np.ndarray, pad_degree_to: int = 1) -> PackedGraph:
    """Pack a dense weighted matrix (typically L) into ELL layout."""
    matrix = np.asarray(matrix)
    n = matrix.shape[0]
    mask = matrix != 0
    deg = mask.sum(axis=1).astype(np.int32)
    dmax = max(int(deg.max(initial=0)), pad_degree_to)
    neighbors = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, dmax))
    weights = np.zeros((n, dmax), dtype=np.float32)
    for i in range(n):
        cols = np.flatnonzero(mask[i])
        neighbors[i, : cols.size] = cols
        weights[i, : cols.size] = matrix[i, cols]
    return _packed(neighbors, weights, deg)


def pack_csr(csr, pad_degree_to: int = 1) -> PackedGraph:
    """Pack a scipy CSR matrix into ELL layout (vectorized)."""
    csr = csr.tocsr()
    csr.eliminate_zeros()
    n = csr.shape[0]
    indptr = np.asarray(csr.indptr)
    deg = np.diff(indptr).astype(np.int32)
    dmax = max(int(deg.max(initial=0)), pad_degree_to)
    neighbors = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, dmax))
    weights = np.zeros((n, dmax), dtype=np.float32)
    nnz = csr.indices.size
    if nnz:
        rows = np.repeat(np.arange(n), deg)
        pos = np.arange(nnz) - np.repeat(indptr[:-1], deg)
        neighbors[rows, pos] = csr.indices.astype(np.int32)
        weights[rows, pos] = csr.data.astype(np.float32)
    return _packed(neighbors, weights, deg)


def pack_laplacian(adj, pad_degree_to: int = 1, layout: str = "auto"):
    """Normalized Laplacian of ``adj`` (dense or scipy sparse), packed for
    walking.

    ``layout`` is ``"ell"`` (fixed-width rows), ``"csr"`` (exact nnz, for
    skewed degrees) or ``"auto"``: CSR when a sparse input's ELL padding would
    waste more than 4x the edge memory, else ELL. Dense inputs take ELL unless
    ``"csr"`` is asked for.
    """
    if layout not in ("ell", "auto", "csr"):
        raise ValueError(f"unknown layout {layout!r}; expected 'ell', 'csr' or 'auto'")
    if sp.issparse(adj):
        lap = normalized_laplacian_csr(adj)
        if layout == "csr":
            return csr_graph(lap)
        if layout == "auto":
            deg = np.diff(lap.indptr)
            padding_waste = int(deg.max(initial=1)) * lap.shape[0] / max(lap.nnz, 1)
            if padding_waste > 4 and lap.shape[0] < (1 << 24):
                return csr_graph(lap)
        return pack_csr(lap, pad_degree_to=pad_degree_to)
    lap = normalized_laplacian(np.asarray(adj)).numpy()
    lap[np.abs(lap) < 1e-12] = 0.0
    if layout == "csr":
        return csr_graph(sp.csr_matrix(lap))
    return pack_dense(lap, pad_degree_to=pad_degree_to)


def packed_to_dense(g: PackedGraph) -> torch.Tensor:
    """The dense matrix of an ELL-packed graph (for tests and small N): one
    flat index-add of the live slots, on the graph's device."""
    n, d = g.num_nodes, g.max_degree
    live = torch.arange(d, device=g.device)[None, :] < g.degree[:, None]
    rows = torch.arange(n, device=g.device)[:, None] * n
    flat = (rows + g.neighbors.to(torch.int64)).reshape(-1)
    vals = torch.where(live, g.weights, 0.0).reshape(-1)
    out = torch.zeros(n * n, dtype=g.weights.dtype, device=g.device)
    return out.index_add(0, flat, vals).reshape(n, n)


def generate_noisy_samples(
    kernel: torch.Tensor,
    noise_std: float = 0.1,
    generator: Optional[torch.Generator] = None,
    eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """One draw from ``N(0, K)`` plus iid observation noise, (n, 1).

    ``eps`` = (ε_f, ε_y), two (n, 1) standard-normal draws, gives the draws
    explicitly (the JAX package's are ``normal(k1)``, ``normal(k2)`` of
    ``split(key)``); otherwise they come from ``generator`` on the CPU."""
    n = kernel.shape[0]
    if eps is None:
        eps = tuple(torch.randn((n, 1), generator=generator) for _ in range(2))
    eps_f, eps_y = (e.to(device=kernel.device, dtype=kernel.dtype) for e in eps)
    chol = safe_cholesky(kernel, jitter=1e-6)
    return chol @ eps_f + noise_std * eps_y
