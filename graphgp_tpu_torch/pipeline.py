"""Blocked walk → consolidate pipeline: million-node step matrices on one card.

Counterpart of ``graphgp_tpu/pipeline.py``. A monolithic walk log of the
flagship (N = 1e6, wpn = 1000, L = 5) would be 40 GB, so start nodes are
walked in blocks; each block's (L, B, W) log is consolidated into ELL rows of
a fixed capacity before the next block starts.

Capacity protocol:
  1. Probe: walk block 0 and take its largest count of distinct live columns
     per row, padded by a margin.
  2. Run every block at that capacity; each consolidation reports its own
     largest count.
  3. If any block overflowed, rerun all blocks at the observed maximum plus
     the margin. The counter-based walk RNG keys on global node ids, so a
     rerun, or any other block size, gives the same walks.
"""
from __future__ import annotations

from typing import Optional

import torch

from .devices import resolve_device
from .features import EllFeatures, EllStepMatrices, _consolidate_rows, max_row_distinct
from .graphs import PackedGraph
from .utils import profiling
from .walker import WalkConfig, sample_walk_log

# Budget for one block's (L, B, W) curs+loads log. Consolidation holds about
# eight times the log in flight (the sort's keys, permutation and gathered
# values, the float64 running sum, the int64 segment ids), plus the output
# ELL (L·N·R·8 bytes, ~2.2 GB at the flagship). The JAX package budgets
# 256 MB for a 16 GB TPU; 1 GB keeps the peak near 10 GB of an 80 GB H100
# and cuts the flagship into 38 blocks instead of 150, fewer and larger
# launches of every per-block operation.
DEFAULT_LOG_BUDGET_BYTES = 1 << 30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def auto_block_size(
    num_nodes: int, cfg: WalkConfig, log_budget_bytes: int = DEFAULT_LOG_BUDGET_BYTES
) -> int:
    """Largest start-node block whose (L, B, W) curs+loads log fits the budget."""
    per_node = max(cfg.max_walk_length, 1) * cfg.walks_per_node * 8
    block = max(log_budget_bytes // per_node, 64)
    if block >= num_nodes:
        return num_nodes
    return max(_round_up(block, 8) - 8, 64) if block > 64 else 64


def _blocked_consolidate(graph, seed, cfg, capacity, block, num_blocks):
    n, l = graph.num_nodes, cfg.max_walk_length
    dev = graph.device
    cols = torch.zeros((l, n, capacity), dtype=torch.int32, device=dev)
    vals = torch.zeros((l, n, capacity), dtype=torch.float32, device=dev)
    inv_w = torch.tensor(1.0 / cfg.walks_per_node, dtype=torch.float32, device=dev)
    maxds = []
    for bix in range(num_blocks):
        start = bix * block
        size = min(block, n - start)
        with profiling.span("prep.walks"):
            log = sample_walk_log(graph, seed, cfg, node_offset=start, num_start_nodes=size)
        with profiling.span("prep.consolidate"):
            c, v, maxd = _consolidate_rows(log.curs, log.loads * inv_w, capacity)
            del log
            cols[:, start : start + size] = c
            vals[:, start : start + size] = v
            maxds.append(maxd)
    largest = torch.stack(maxds).max()
    with profiling.host_sync():
        return cols, vals, int(largest)


def blocked_ell_features(
    graph: PackedGraph,
    seed: int,
    cfg: WalkConfig,
    *,
    block_size: Optional[int] = None,
    capacity: Optional[int] = None,
    num_target_nodes: Optional[int] = None,
    log_budget_bytes: int = DEFAULT_LOG_BUDGET_BYTES,
    capacity_margin: float = 1.25,
    multiple: int = 8,
    device="cuda",
) -> EllFeatures:
    """Walk and consolidate a graph of any size into ELL step matrices without
    materializing the full (L, N, W) walk log.

    Args:
        graph: packed graph over the full node set; moved to ``device``.
        seed: walk seed.
        block_size: start nodes per block (default: sized to the log budget).
        capacity: ELL row capacity; None probes block 0 and pads by
            ``capacity_margin``, restarting on overflow.
        device: where to walk ("cuda" by default; raises without a card).

    Returns:
        EllFeatures with (L, N, capacity) cols/vals on ``device``.
    """
    graph = graph.to(resolve_device(device))
    n = graph.num_nodes
    w = cfg.walks_per_node
    nt = num_target_nodes or n
    block = min(block_size or auto_block_size(n, cfg, log_budget_bytes), n)
    num_blocks = -(-n // block)

    if capacity is None:
        with profiling.span("prep.walks"):
            probe = sample_walk_log(graph, seed, cfg, node_offset=0, num_start_nodes=block)
        with profiling.span("prep.consolidate"):
            distinct = max_row_distinct(probe)
            del probe
            with profiling.host_sync():
                probed = max(int(distinct), 1)
        capacity = min(_round_up(int(probed * capacity_margin), multiple), w)

    while True:
        cols, vals, maxd = _blocked_consolidate(graph, seed, cfg, capacity, block, num_blocks)
        if maxd <= capacity or capacity >= w:
            break
        # A later block had fatter rows than the probe: rerun at the observed
        # maximum plus margin (same walks, thanks to the counter-based RNG).
        capacity = min(_round_up(int(maxd * capacity_margin), multiple), w)
    return EllFeatures(EllStepMatrices(cols=cols, vals=vals, num_target_nodes=nt))
