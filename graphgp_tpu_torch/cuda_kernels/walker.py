"""K4, the fused walk → dense step-matrix sampler, and its plain PyTorch version.

``M[l, i, j] = (1/W) · Σ_w load_l(i, w) · [cur_l(i, w) = j]`` for
``walks_per_node`` walks from every node, on the splitmix32 stream that every
walker of this package shares, as an (L, N, N) float32 tensor. Counterpart of
``graphgp_tpu/pallas_kernels/walker.py``
(``sample_dense_step_matrices_pallas``); the CUDA kernel is
``csrc/walker.cu``.

The kernel and the plain version walk the same walks bit for bit. They differ
in the order of the float32 additions (the kernel adds each record into the
output with a float atomic, so two launches may differ in the last bits too)
and in one rounding: the kernel divides the sum by W at the end, the plain
version divides each load by W before adding. Step 0 of the kernel is exactly the identity.

The one-hot MXU gathers, the base-64 digit table, the bf16 three-way split,
the pooling matrix and the power-of-two walk block of the Pallas kernel are
TPU strategies with no counterpart here: any ``walks_per_node`` ≥ 1 is right.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..graphs import CsrGraph, PackedGraph
from ..walker import WalkConfig, dense_step_matrices, key_words, sample_walk_log
from . import _build

# The dense regime: (L, N, N) step matrices are the right representation only
# for small graphs (the JAX package's PALLAS_MAX_NODES).
MAX_NODES = 4096
MAX_THREADS = 1024
# Dynamic shared memory one block may ask for on sm_90 (227 KB).
MAX_DYNAMIC_SMEM_BYTES = 232448
# The packed table's 16-bit degree field.
MAX_TABLE_WIDTH = 0xFFFF

# Kernel launches since the last reset; chip_smoke.py reads it.
launches = 0


def shared_memory_bytes(max_walk_length: int) -> int:
    """A block's dynamic shared memory: the hash prefix, two words for each
    of the walk's steps (the step matrices themselves live in the output)."""
    need = 8 * max_walk_length
    if need > MAX_DYNAMIC_SMEM_BYTES:
        raise ValueError(
            f"max_walk_length={max_walk_length} needs {need} bytes of shared memory for the "
            f"hash prefix; a block may have {MAX_DYNAMIC_SMEM_BYTES}"
        )
    return need


def block_threads(walks_per_node: int, cells: int) -> int:
    """Threads of a block, in whole warps, at most 1024: one per walk, and no
    fewer than one per eight of the block's ``cells`` (L × N: its rows of the
    output, which every thread helps to clear and to divide by W)."""
    want = max(walks_per_node, -(-cells // 8))
    return min(MAX_THREADS, max(32, -(-want // 32) * 32))


def packed_table_plain(graph: PackedGraph) -> torch.Tensor:
    """The (N, D, 2) int32 table the kernel packs before its walks, one
    8-byte entry per (node, slot): word 0 holds the neighbour id in its low
    16 bits and the neighbour's degree cut to [0, D] in its high 16, or
    0xFFFF (degree 0) for an id outside [0, N); word 1 holds the weight's
    bits."""
    nb = graph.neighbors.to(torch.int64)
    n, d = nb.shape
    deg = graph.degree.to(torch.int64)[nb.clamp(0, n - 1)].clamp(0, d)
    word = torch.where((nb >= 0) & (nb < n), nb | (deg << 16), 0xFFFF)
    word = torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)
    return torch.stack([word, graph.weights.contiguous().view(torch.int32)], dim=-1)


def sample_dense_step_matrices_plain(
    graph: PackedGraph, seed: int, cfg: WalkConfig,
    log_budget_bytes: Optional[int] = None,
) -> torch.Tensor:
    """The gather walk and one scatter-add (``walker.sample_walk_log`` +
    ``dense_step_matrices``), over blocks of start nodes when the (L, N, W)
    walk log would exceed ``log_budget_bytes`` (default: the blocked pipeline's
    budget); blocking never changes a row."""
    from ..pipeline import DEFAULT_LOG_BUDGET_BYTES, auto_block_size  # imports features, which imports this package

    n = graph.num_nodes
    budget = DEFAULT_LOG_BUDGET_BYTES if log_budget_bytes is None else log_budget_bytes
    block = auto_block_size(n, cfg, budget)
    if block >= n:
        return dense_step_matrices(sample_walk_log(graph, seed, cfg), cfg)
    out = torch.empty((cfg.max_walk_length, n, n), dtype=torch.float32, device=graph.device)
    for start in range(0, n, block):
        size = min(block, n - start)
        log = sample_walk_log(graph, seed, cfg, node_offset=start, num_start_nodes=size)
        out[:, start : start + size] = dense_step_matrices(log, cfg, num_target_nodes=n)
    return out


def _check_graph(graph: PackedGraph) -> None:
    if isinstance(graph, CsrGraph):
        raise ValueError(
            "sample_dense_step_matrices_cuda: K4 walks the fixed-width ELL table of a "
            "PackedGraph; a CsrGraph (skewed degrees) takes the gather walker "
            "(sample_dense_step_matrices_plain)"
        )
    nb, wt, deg = graph.neighbors, graph.weights, graph.degree
    if not (nb.is_cuda and wt.is_cuda and deg.is_cuda):
        raise ValueError("sample_dense_step_matrices_cuda: the graph must lie on a CUDA device")
    if not (nb.device == wt.device == deg.device):
        raise ValueError("sample_dense_step_matrices_cuda: graph tensors on different devices")
    if nb.dtype != torch.int32 or wt.dtype != torch.float32 or deg.dtype != torch.int32:
        raise ValueError(
            "sample_dense_step_matrices_cuda: want int32 neighbors, float32 weights, int32 degree"
        )
    if nb.dim() != 2 or wt.shape != nb.shape or deg.shape != (nb.shape[0],):
        raise ValueError(
            f"sample_dense_step_matrices_cuda: bad shapes {tuple(nb.shape)} "
            f"{tuple(wt.shape)} {tuple(deg.shape)}"
        )
    if not (nb.is_contiguous() and wt.is_contiguous() and deg.is_contiguous()):
        raise ValueError("sample_dense_step_matrices_cuda: graph tensors must be contiguous")
    n, d = nb.shape
    if n > MAX_NODES:
        raise ValueError(
            f"the fused dense walker supports N <= {MAX_NODES}; got {n}. "
            "Use the walk-log / ELL path (pipeline.blocked_ell_features) for larger graphs."
        )
    if n < 1 or not 1 <= d <= MAX_TABLE_WIDTH:
        raise ValueError(f"sample_dense_step_matrices_cuda: graph table {(n, d)} out of range")


def sample_dense_step_matrices_cuda(graph: PackedGraph, seed: int, cfg: WalkConfig) -> torch.Tensor:
    """Launch K4 once: an ELL graph (int32 neighbors (N, D), float32 weights
    (N, D), int32 degree (N,), contiguous on one CUDA device, N ≤ 4096) →
    float32 (L, N, N) step matrices, every element written by the kernel.
    Nothing here waits for the device. The tables' contents are not checked:
    the pack functions of ``graphs`` make them, and the kernel stays inside
    them whatever they hold (a neighbour id outside [0, N) ends its walk)."""
    global launches
    _check_graph(graph)
    n, d = graph.neighbors.shape
    w, steps = cfg.walks_per_node, cfg.max_walk_length
    if w < 1 or steps < 0:
        raise ValueError(f"sample_dense_step_matrices_cuda: walks_per_node={w}, L={steps}")
    if not 0.0 <= cfg.p_halt < 1.0:
        raise ValueError(f"sample_dense_step_matrices_cuda: p_halt={cfg.p_halt} not in [0, 1)")
    dev = graph.device
    out = torch.empty((steps, n, n), dtype=torch.float32, device=dev)
    if steps == 0:
        return out
    shared_memory_bytes(steps)
    k0, k1 = key_words(seed)
    lib = _build.load()
    table = torch.empty((n, d, 2), dtype=torch.int32, device=dev)  # packed by the launch
    with _build.on_device(dev):
        rc = lib.walk_step_matrices_f32(
            graph.neighbors.data_ptr(), graph.weights.data_ptr(), graph.degree.data_ptr(),
            table.data_ptr(), out.data_ptr(), n, d, w, steps, int(cfg.ablation), k0, k1,
            # both rounded once from double, as the plain version's float32 scalars
            ctypes.c_float(cfg.p_halt), ctypes.c_float(1.0 / (1.0 - cfg.p_halt)),
            block_threads(w, steps * n), _build.stream(dev),
        )
    launches += 1
    _build.check(rc, "walk_step_matrices_f32")
    return out
