"""Plain reference of graph random features: the normalized Laplacian, the
splitmix32 counter-hash walks, and the step matrices they estimate.

Written from the method's definition (Reid et al., "General graph random
features"): each of ``W`` walks from node ``i`` halts with probability
``p_halt`` before each step, moves to a uniformly drawn nonzero of the
current node's row of ``L = I - D^-1/2 A D^-1/2`` (in column order), and
multiplies its load by ``deg · weight / (1 - p_halt)``. The step matrix
``M_l[i, j]`` is the sum of the loads of ``i``'s walks that sit at ``j`` after
``l`` steps, divided by ``W``. The uniforms come from the splitmix32 hash of
``(key words, 2l or 2l+1, start node, walk)`` with the key words ``(0, seed)``.

Sums are taken in the dtype asked for: float64 for the reference, bfloat16
for the control. Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import scipy.sparse as sp
import torch

_U32 = 0xFFFFFFFF


def _mix(h):
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _U32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _U32
    return h ^ (h >> 16)


def _hash(*words):
    h = 0x9E3779B9
    for w in words:
        h = _mix(h ^ w)
    return h


@dataclasses.dataclass(frozen=True)
class Laplacian:
    """Rows of the normalized Laplacian in CSR order, float32 weights."""

    indptr: torch.Tensor   # int64 (N + 1,)
    indices: torch.Tensor  # int64 (nnz,)
    weights: torch.Tensor  # float32 (nnz,)

    @property
    def num_nodes(self) -> int:
        return self.indptr.numel() - 1

    def to(self, device) -> "Laplacian":
        return Laplacian(self.indptr.to(device), self.indices.to(device), self.weights.to(device))


def laplacian(adjacency) -> Laplacian:
    """``I - D^-1/2 A D^-1/2`` from a scipy adjacency, in float64, explicit
    zeros dropped, columns sorted, weights rounded to float32."""
    a = sp.csr_matrix(adjacency, dtype=np.float64)
    deg = np.asarray(a.sum(axis=1)).ravel()
    inv = np.zeros_like(deg)
    inv[deg > 0] = 1.0 / np.sqrt(deg[deg > 0])
    d = sp.diags(inv)
    lap = (sp.eye(a.shape[0], format="csr") - d @ a @ d).tocsr()
    lap.eliminate_zeros()
    lap.sort_indices()
    return Laplacian(
        torch.from_numpy(lap.indptr.astype(np.int64)),
        torch.from_numpy(lap.indices.astype(np.int64)),
        torch.from_numpy(lap.data.astype(np.float32)),
    )


def walk(lap: Laplacian, starts: torch.Tensor, seed: int, walks_per_node: int,
         p_halt: float, length: int):
    """Walks from ``starts``: positions (length, R, W) int64 and loads
    (length, R, W) float32, 0 once halted. Float32 load arithmetic, as the
    method is stated for float32 features."""
    dev = lap.indptr.device
    starts = starts.to(device=dev, dtype=torch.int64)
    r, w = starts.numel(), walks_per_node
    node_word = starts[:, None]
    walk_word = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
    k0, k1 = 0, int(seed) & _U32
    deg = (lap.indptr[1:] - lap.indptr[:-1])
    halt_p = torch.tensor(p_halt, dtype=torch.float32, device=dev)
    keep_inv = torch.tensor(1.0 / (1.0 - p_halt), dtype=torch.float32, device=dev)

    def uniform(word):
        bits = _mix(_mix(_hash(k0, k1, word) ^ node_word) ^ walk_word)
        return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))

    pos = torch.empty((length, r, w), dtype=torch.int64, device=dev)
    loads = torch.empty((length, r, w), dtype=torch.float32, device=dev)
    cur = starts[:, None].expand(r, w).clone()
    load = torch.ones((r, w), dtype=torch.float32, device=dev)
    alive = torch.ones((r, w), dtype=torch.bool, device=dev)
    for step in range(length):
        pos[step] = cur
        loads[step] = torch.where(alive, load, torch.zeros_like(load))
        if step == length - 1:
            break
        u_halt, u_pick = uniform(2 * step), uniform(2 * step + 1)
        d = deg[cur]
        degf = d.to(torch.float32)
        pick = torch.minimum((u_pick * degf).to(torch.int64), torch.clamp(d - 1, min=0))
        slot = torch.clamp(lap.indptr[cur] + pick, max=max(lap.indices.numel() - 1, 0))
        nxt, wgt = lap.indices[slot], lap.weights[slot]
        halted = (d == 0) | (u_halt < halt_p)
        alive = alive & ~halted
        new_load = load * degf * wgt * keep_inv
        cur = torch.where(alive, nxt, cur)
        load = torch.where(alive, new_load, load)
    return pos, loads


@dataclasses.dataclass
class StepRows:
    """Step matrices restricted to some rows: one (R × N) sparse matrix per
    step, in ``dtype``; ``rows`` are the global ids of the R rows."""

    rows: np.ndarray
    steps: List[torch.Tensor]  # sparse COO (R, N), coalesced
    num_nodes: int

    def row_entries(self, k: int, step: int):
        """(columns, values) of local row ``k`` at ``step``, columns sorted."""
        m = self.steps[step]
        ix, v = m.indices(), m.values()
        sel = ix[0] == k
        return ix[1][sel].cpu().numpy(), v[sel].cpu().to(torch.float64).numpy()


def step_rows(lap: Laplacian, rows, seed: int, walks_per_node: int, p_halt: float,
              length: int, dtype=torch.float64, block: int = 4096) -> StepRows:
    """The step matrices' rows ``rows``, walked and summed in blocks of rows.
    Each walk's share ``load / W`` is taken and summed in ``dtype``."""
    rows = np.asarray(rows, dtype=np.int64)
    n = lap.num_nodes
    dev = lap.indptr.device
    parts = [[] for _ in range(length)]
    for lo in range(0, len(rows), block):
        chunk = torch.from_numpy(rows[lo:lo + block]).to(dev)
        pos, loads = walk(lap, chunk, seed, walks_per_node, p_halt, length)
        local = torch.arange(lo, lo + chunk.numel(), device=dev)[:, None].expand_as(pos[0])
        for step in range(length):
            share = loads[step].to(dtype) / walks_per_node
            live = loads[step] != 0
            parts[step].append((local[live], pos[step][live], share[live]))
        del pos, loads
    steps = []
    for step in range(length):
        r = torch.cat([p[0] for p in parts[step]])
        c = torch.cat([p[1] for p in parts[step]])
        v = torch.cat([p[2] for p in parts[step]])
        m = torch.sparse_coo_tensor(torch.stack([r, c]), v, (len(rows), n),
                                    check_invariants=False).coalesce()
        steps.append(m)
    return StepRows(rows=rows, steps=steps, num_nodes=n)


def within_hops(adjacency, nodes, hops: int) -> np.ndarray:
    """Sorted nodes within ``hops`` edges of any of ``nodes``: the only rows
    whose walks of ``hops`` steps can reach ``nodes``."""
    a = sp.csr_matrix(adjacency)
    frontier = np.unique(np.asarray(nodes, dtype=np.int64))
    seen = frontier
    for _ in range(hops):
        nxt = np.unique(a[frontier].indices).astype(np.int64)
        frontier = np.setdiff1d(nxt, seen)
        seen = np.union1d(seen, frontier)
        if frontier.size == 0:
            break
    return seen
