"""Graph-kernel constructors: GRF estimates and exact / deterministic baselines.

Counterpart of ``graphgp_tpu/kernels.py``. Walk seeds are integers (the JAX
package's ``PRNGKey(seed)``); every function runs on ``device`` ("cuda" by
default, raising without a card; "cpu" for the plain PyTorch path).

:func:`step_matrices_for_adjacency` is where the dense regime meets kernel K4
(``cuda_kernels/walker.py``): on a CUDA device, ``method="auto"`` launches it
for every ELL-packed graph of at most 4096 nodes. Skewed-degree graphs pack
as :class:`~graphgp_tpu_torch.graphs.CsrGraph` and take the gather walker,
as in the JAX package: K4's neighbour table is the fixed-width ELL layout.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from .cuda_kernels import walker as k_walker
from .devices import resolve_device
from .features import DenseFeatures
from .graphs import PackedGraph, normalized_laplacian, pack_dense, pack_laplacian
from .modulators import diffusion_modulator
from .walker import WalkConfig, sample_dense_step_matrices


def _dense_adjacency(adj, device) -> torch.Tensor:
    dense = adj.toarray() if sp.issparse(adj) else np.asarray(adj)
    return torch.from_numpy(np.asarray(dense, dtype=np.float32)).to(device)


def _walk_graph(adj, ablation: bool):
    """The matrix the walks run on: the normalized Laplacian (ELL, or CSR for
    skewed degrees), or under ``ablation`` the raw adjacency (ELL)."""
    if ablation:
        return pack_dense(adj.toarray() if sp.issparse(adj) else np.asarray(adj))
    return pack_laplacian(adj)


def step_matrices_for_adjacency(
    adj,
    seed: int,
    walks_per_node: int = 50,
    p_halt: float = 0.1,
    max_walk_length: int = 10,
    ablation: bool = False,
    method: str = "auto",
    device="cuda",
) -> torch.Tensor:
    """Adjacency → normalized Laplacian → dense (L, N, N) step matrices.

    ``ablation=True`` walks the *raw adjacency* with the ad-hoc load update
    ``load = weight``.

    method: "auto" takes the fused CUDA walk kernel (K4) when ``device`` is a
    CUDA device, the graph packs as ELL and N ≤ 4096, else the gather walker;
    "cuda" / "gather" force a path. The choice is made from the layout before
    any launch. On a CUDA device a kernel that fails to build or launch
    raises; nothing falls back to the gather walker.
    """
    cfg = WalkConfig(
        walks_per_node=walks_per_node,
        p_halt=p_halt,
        max_walk_length=max_walk_length,
        ablation=ablation,
    )
    dev = resolve_device(device)
    graph = _walk_graph(adj, ablation).to(dev)
    if method == "auto":
        use_kernel = (
            dev.type == "cuda"
            and isinstance(graph, PackedGraph)
            and graph.num_nodes <= k_walker.MAX_NODES
        )
        method = "cuda" if use_kernel else "gather"
    if method == "cuda":
        return k_walker.sample_dense_step_matrices_cuda(graph, seed, cfg)
    if method != "gather":
        raise ValueError(f"unknown step-matrix method {method!r}")
    return k_walker.sample_dense_step_matrices_plain(graph, seed, cfg)


# Largest dense (L, N, N) step tensor the dense-regime CLIs materialize before
# they switch to the blocked walk → consolidate pipeline (the value the JAX
# package uses, so both packages switch at the same graph size).
DENSE_STEP_BYTES_LIMIT = 4 << 30


def features_for_adjacency(
    adj,
    seed: int,
    walks_per_node: int = 50,
    p_halt: float = 0.1,
    max_walk_length: int = 10,
    ablation: bool = False,
    method: str = "auto",
    dense_bytes_limit: int = DENSE_STEP_BYTES_LIMIT,
    layout: str = "auto",
    device="cuda",
):
    """Adjacency → GRF feature operator, with a large-graph guardrail.

    The one entry point of the experiment CLIs: in the dense regime it
    returns :class:`DenseFeatures` from :func:`step_matrices_for_adjacency`;
    above ``dense_bytes_limit`` it switches to the blocked walk → consolidate
    pipeline, which never materializes the (L, N, W) log, and the ``auto``
    feature layout: the stencil layout on structured graphs, ELL with its
    column-sorted transpose on unstructured ones.
    """
    n = adj.shape[0]
    if max_walk_length * n * n * 4 <= dense_bytes_limit:
        return DenseFeatures(
            step_matrices_for_adjacency(
                adj, seed, walks_per_node, p_halt, max_walk_length, ablation, method, device
            )
        )
    from .pipeline import blocked_ell_features
    from .preprocessor import _apply_layout

    cfg = WalkConfig(
        walks_per_node=walks_per_node,
        p_halt=p_halt,
        max_walk_length=max_walk_length,
        ablation=ablation,
    )
    feats = blocked_ell_features(_walk_graph(adj, ablation), seed, cfg, device=device)
    return _apply_layout(feats.mats, layout, None)


def fast_general_grf_kernel(
    adj,
    modulator_vector: Sequence[float],
    walks_per_node: int = 50,
    p_halt: float = 0.1,
    max_walk_length: Optional[int] = None,
    seed: int = 42,
    device="cuda",
) -> torch.Tensor:
    """GRF kernel estimate ``K = ΦΦᵀ``, ``Φ = Σ_l f_l M_l`` (walk seed 42 by
    default, as the reference hard-codes)."""
    dev = resolve_device(device)
    f = torch.as_tensor(modulator_vector, dtype=torch.float32).to(dev)
    if max_walk_length is None:
        max_walk_length = int(f.shape[0])
    elif max_walk_length != int(f.shape[0]):
        raise ValueError(
            f"modulator_vector has length {int(f.shape[0])} but "
            f"max_walk_length={max_walk_length}; they must match "
            "(one modulation weight per walk step)."
        )
    mats = step_matrices_for_adjacency(
        adj, seed, walks_per_node, p_halt, max_walk_length, device=dev
    )
    phi = torch.einsum("l,lij->ij", f, mats)
    return phi @ phi.T


def fast_diffusion_grf_kernel(
    adj,
    beta: float = 1.0,
    walks_per_node: int = 50,
    p_halt: float = 0.1,
    max_walk_length: int = 10,
    seed: int = 42,
    device="cuda",
) -> torch.Tensor:
    """Diffusion-kernel GRF estimate: modulator = Taylor of exp(−βL/2)."""
    f = diffusion_modulator(max_walk_length, beta)
    return fast_general_grf_kernel(adj, f, walks_per_node, p_halt, max_walk_length, seed, device)


def diffusion_kernel(adj, beta: float = 1.0, device="cuda") -> torch.Tensor:
    """Exact heat kernel ``exp(−βL)`` ground truth, by ``eigh`` (L is
    symmetric PSD)."""
    lap = normalized_laplacian(_dense_adjacency(adj, resolve_device(device)))
    evals, evecs = torch.linalg.eigh(lap)
    return (evecs * torch.exp(-beta * evals)[None, :]) @ evecs.T


def _power_series(base: torch.Tensor, coefficients: torch.Tensor) -> torch.Tensor:
    """``Σ_p c_p · base^p``."""
    power = torch.eye(base.shape[0], dtype=base.dtype, device=base.device)
    acc = torch.zeros_like(base)
    for cp in coefficients:
        acc = acc + cp * power
        power = power @ base
    return acc


def feature_matrix_kernel(
    adj, beta: float = 1.0, max_expansion: int = 10, device="cuda"
) -> torch.Tensor:
    """PoFM deterministic baseline: ``K_f = Σ_l f_l L^l``, ``K = K_f K_fᵀ``."""
    lap = normalized_laplacian(_dense_adjacency(adj, resolve_device(device)))
    kf = _power_series(lap, diffusion_modulator(max_expansion, beta).to(lap.device))
    return kf @ kf.T


def general_pofm_feature_matrix(adj, coefficients, device="cuda") -> torch.Tensor:
    """``Σ_p c_p A^p`` over raw-adjacency powers, the learnable-PoFM feature
    matrix."""
    a = _dense_adjacency(adj, resolve_device(device))
    return _power_series(a, torch.as_tensor(coefficients, dtype=torch.float32).to(a.device))


def pofm_features(
    adj, max_expansion: int = 10, on_adjacency: bool = False, device="cuda"
) -> torch.Tensor:
    """Deterministic PoFM step matrices: exact powers ``L^l`` (or ``A^l``) as
    an (L, N, N) tensor usable as :class:`DenseFeatures`, the zero-variance,
    O(N³L) counterpart of GRF step matrices. Feed to the same GP stack
    (``exact.fit`` with kind "free" or "diffusion")."""
    base = _dense_adjacency(adj, resolve_device(device))
    if not on_adjacency:
        base = normalized_laplacian(base)
    powers = [torch.eye(base.shape[0], dtype=base.dtype, device=base.device)]
    for _ in range(max_expansion - 1):
        powers.append(powers[-1] @ base)
    return torch.stack(powers[:max_expansion])  # powers[l] = base^l


def grf_kernel_unbiased(
    adj,
    modulator_vector: Sequence[float],
    walks_per_node: int = 50,
    p_halt: float = 0.1,
    seeds: Sequence[int] = (42, 84),
    device="cuda",
) -> torch.Tensor:
    """Two-independent-GRF estimator ``K = Φ₁Φ₂ᵀ``, unbiased for the
    *squared* kernel and, unlike ``ΦΦᵀ``, not guaranteed PSD. The two walk
    seeds are explicit (the reference's 42 and 84); the JAX package derives
    its pair by splitting one key, which no integer seed reproduces."""
    seed1, seed2 = seeds
    dev = resolve_device(device)
    f = torch.as_tensor(modulator_vector, dtype=torch.float32).to(dev)
    cfg = WalkConfig(
        walks_per_node=walks_per_node, p_halt=p_halt, max_walk_length=int(f.shape[0])
    )
    graph = pack_laplacian(adj).to(dev)
    phi1 = torch.einsum("l,lij->ij", f, sample_dense_step_matrices(graph, seed1, cfg))
    phi2 = torch.einsum("l,lij->ij", f, sample_dense_step_matrices(graph, seed2, cfg))
    return phi1 @ phi2.T


def gram_from_phi(phi: torch.Tensor, idx1=None, idx2=None, diag: bool = False) -> torch.Tensor:
    """``K[idx1, idx2] = Φ[idx1] Φ[idx2]ᵀ`` with node-index gathers, the
    indexing contract of the GP kernel adapters."""

    def rows(idx):
        if idx is None:
            return phi
        return phi[torch.as_tensor(idx, dtype=torch.int64, device=phi.device)]

    p1, p2 = rows(idx1), rows(idx2)
    if diag:
        return (p1 * p2).sum(dim=-1)
    return p1 @ p2.T
