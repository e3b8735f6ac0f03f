"""Vectorized random-walk engine.

Counterpart of ``sample_walk_log``, ``dense_step_matrices``,
``sample_dense_step_matrices`` and ``fused_phi`` in ``graphgp_tpu/walker.py``. All
``num_start_nodes × walks_per_node`` walks advance in lockstep, one step at a
time; a halted walk keeps its lane with load 0. Randomness is the splitmix32
counter hash of ``(key, step, global node, walk)``, so the walks do not depend
on how start nodes are blocked, and an integer seed gives the same walks as
``jax.random.PRNGKey(seed)`` gives the JAX package (its key words are
``(0, seed)``).

torch has no usable unsigned 32-bit arithmetic (``>>`` on uint32 is not
implemented), so the hash runs in int64 holding u32 values, masked with
``0xFFFFFFFF`` after every multiply; two's-complement wrap keeps the low
32 bits right. The leading hash words are scalars and are mixed in Python
integers; only the last mix runs over the (nodes, walks) lanes.

A step looks up the current node's row in one of two layouts: the ELL table
of a :class:`PackedGraph` or the exact rows of a :class:`CsrGraph` (skewed
degrees). Both pick ``min(floor(u·deg), deg − 1)`` into the row, as the JAX
package's flat ELL and CSR lookups do. Its packed-table and hop-table lookups
are TPU strategies with bit-identical results and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from .graphs import CsrGraph, PackedGraph

Graph = Union[PackedGraph, CsrGraph]

_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class WalkConfig:
    """Walk hyperparameters."""

    walks_per_node: int = 50
    p_halt: float = 0.1
    max_walk_length: int = 10
    ablation: bool = False


class WalkLog(NamedTuple):
    """Raw walk trace.

    ``M_l[i, j] = (1/W) * sum_w loads[l, i, w] * [curs[l, i, w] == j]``.

    curs: int32 (L, N, W), node occupied at step l by walk w from node i.
    loads: float32 (L, N, W), signed importance weight, 0 once halted.
    """

    curs: torch.Tensor
    loads: torch.Tensor

    @property
    def max_walk_length(self) -> int:
        return self.curs.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.curs.shape[1]

    @property
    def walks_per_node(self) -> int:
        return self.curs.shape[2]


def _mix(h):
    """splitmix32 finalizer on u32 values held in Python ints or int64 tensors."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _U32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _U32
    h = h ^ (h >> 16)
    return h


def hash_words(*words):
    """Combine u32 words (Python ints or broadcastable int64 tensors) into one
    well-mixed u32 per element, as ``walker._hash_words`` does."""
    h = 0x9E3779B9
    for w in words:
        h = _mix(h ^ w)
    return h


def uniform_01(bits: torch.Tensor) -> torch.Tensor:
    """u32 → float32 uniform in [0, 1) with 24 bits of entropy."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def key_words(seed: int):
    """The two key words of ``jax.random.PRNGKey(seed)``: ``(0, seed)``."""
    return 0, int(seed) & _U32


def _lookup(graph: Graph):
    """``lookup(cur, u_pick) -> (degree as float32, next node, weight)``: the
    uniform pick into the row of each lane's current node. A node of degree 0
    reads slot 0 of its row (clamped into the table) and halts."""
    if isinstance(graph, CsrGraph):
        row_start = graph.node_table[:, 0].to(torch.int64)
        degree, neighbors, weights = graph.degree, graph.neighbors, graph.weights
        last = max(graph.nnz - 1, 0)

        def slot(cur, pick):
            return torch.clamp(row_start[cur] + pick, max=last)
    else:
        degree = graph.degree
        neighbors, weights = graph.neighbors.reshape(-1), graph.weights.reshape(-1)
        dmax = graph.max_degree

        def slot(cur, pick):
            return cur * dmax + pick

    def lookup(cur, u_pick):
        deg = degree[cur]
        degf = deg.to(torch.float32)
        pick = torch.minimum((u_pick * degf).to(torch.int64), torch.clamp(deg - 1, min=0))
        idx = slot(cur, pick)
        return degf, neighbors[idx].to(torch.int64), weights[idx]

    return lookup


def sample_walk_log(
    graph: Graph,
    seed: int,
    cfg: WalkConfig,
    node_offset: int = 0,
    num_start_nodes: Optional[int] = None,
) -> WalkLog:
    """Run ``walks_per_node`` importance-sampled walks from each start node.

    Args:
        graph: ELL- or CSR-packed graph over the full node set, on the device
            to walk on.
        seed: integer walk seed (the JAX package's ``PRNGKey(seed)``).
        cfg: walk configuration.
        node_offset: global id of the first start node.
        num_start_nodes: walk this many nodes from ``node_offset`` (default all).

    Returns:
        WalkLog with curs/loads of shape (L, num_start_nodes, W).
    """
    dev = graph.device
    n = graph.num_nodes if num_start_nodes is None else num_start_nodes
    w, steps = cfg.walks_per_node, cfg.max_walk_length
    curs = torch.empty((steps, n, w), dtype=torch.int32, device=dev)
    loads = torch.empty((steps, n, w), dtype=torch.float32, device=dev)
    if steps == 0:
        return WalkLog(curs, loads)

    k0, k1 = key_words(seed)
    start = node_offset + torch.arange(n, dtype=torch.int64, device=dev)
    node_word = start[:, None]
    walk_word = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    lookup = _lookup(graph)
    p_halt = torch.tensor(cfg.p_halt, dtype=torch.float32, device=dev)
    inv_keep = torch.tensor(1.0 / (1.0 - cfg.p_halt), dtype=torch.float32, device=dev)

    def uniform(word: int) -> torch.Tensor:
        per_node = _mix(hash_words(k0, k1, word) ^ node_word)
        return uniform_01(_mix(per_node ^ walk_word))

    cur = start[:, None].expand(n, w).contiguous()
    load = torch.ones((n, w), dtype=torch.float32, device=dev)
    alive = torch.ones((n, w), dtype=torch.bool, device=dev)
    for l in range(steps):
        curs[l] = cur
        loads[l] = torch.where(alive, load, 0.0)
        if l == steps - 1:
            break  # the last transition is never recorded
        u_halt = uniform(2 * l)
        u_pick = uniform(2 * l + 1)
        degf, nxt, wgt = lookup(cur, u_pick)
        halt = (degf == 0) | (u_halt < p_halt)
        new_load = wgt if cfg.ablation else load * degf * wgt * inv_keep
        alive = alive & ~halt
        cur = torch.where(alive, nxt, cur)
        load = torch.where(alive, new_load, load)
    return WalkLog(curs, loads)


def dense_step_matrices(
    log: WalkLog, cfg: WalkConfig, num_target_nodes: Optional[int] = None
) -> torch.Tensor:
    """Consolidate a WalkLog into dense step matrices ``M`` of shape (L, N, Nt):
    ``M[l]`` is the Monte-Carlo estimate of the l-th power of the walk matrix.
    One flat scatter-add over all (step, start, cur) triples."""
    l, n, w = log.curs.shape
    nt = num_target_nodes or n
    dev = log.curs.device
    step_ix = torch.arange(l, device=dev)[:, None, None]
    start = torch.arange(n, device=dev)[None, :, None]
    flat = ((step_ix * n + start) * nt + log.curs.to(torch.int64)).reshape(-1)
    vals = (log.loads / cfg.walks_per_node).reshape(-1)
    out = torch.zeros(l * n * nt, dtype=torch.float32, device=dev)
    return out.index_add(0, flat, vals).reshape(l, n, nt)


def sample_dense_step_matrices(graph: Graph, seed: int, cfg: WalkConfig) -> torch.Tensor:
    """Walk and consolidate: (L, N, N) dense step matrices, the step axis
    first. The small-N sampler (the walk log is L·N·W entries and the result
    L·N² floats)."""
    return dense_step_matrices(sample_walk_log(graph, seed, cfg), cfg)


def fused_phi(graph: Graph, seed: int, modulator, cfg: WalkConfig) -> torch.Tensor:
    """Sample walks and accumulate ``Φ = Σ_l f_l · M_l`` (N, N) directly,
    skipping the (L, N, N) intermediate: for a fixed modulator. To learn
    hyperparameters prefer the step matrices, which make Φ(f) a contraction."""
    log = sample_walk_log(graph, seed, cfg)
    l, n, w = log.curs.shape
    dev = log.curs.device
    f = torch.as_tensor(modulator, dtype=torch.float32, device=dev).reshape(l, 1, 1)
    start = torch.arange(n, device=dev)[None, :, None]
    flat = (start * n + log.curs.to(torch.int64)).reshape(-1)
    vals = (f * log.loads / cfg.walks_per_node).reshape(-1)
    out = torch.zeros(n * n, dtype=torch.float32, device=dev)
    return out.index_add(0, flat, vals).reshape(n, n)
