#!/usr/bin/env python3
"""CG on a train block as CUDA graphs of ``linalg.GRAPH_CHUNK`` iterations
against the one-iteration loop that reads the host every iteration, on the
card.

The operator is the fits' and draws' (``gp.iterative.make_gram_matvec_block``)
on a (T, T) = (1010, 1010) ``K_tt`` with eigenvalues log-spaced over six
decades, σ² 0.01 and a mask of 910 live slots, as the batch-100 BO cells'
last refit. Solves at B = 1 and 16, tol 0 and a fixed iteration count (every
iteration live), in turns: loop, graph, graph, loop; prints each turn's
milliseconds an iteration and host reads a solve, and whether the graph's
x, residual and iterations equal the loop's bit for bit.

Usage: python3 benchmarks/torch_cg_graph.py   (needs a CUDA card; run from the repo's root)
"""
import statistics
import sys
import time

sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from graphgp_tpu_torch import linalg
from graphgp_tpu_torch.gp import iterative
from graphgp_tpu_torch.utils import profiling

T, LIVE, ITERS, REPEATS = 1010, 910, 96, 5
dev = torch.device("cuda:0")
cs.log(cs.card_line())
gen = torch.Generator(device=dev).manual_seed(0)
q, _ = torch.linalg.qr(torch.randn((T, T), generator=gen, device=dev, dtype=torch.float64))
k_tt = ((q * torch.logspace(-3, 3, T, device=dev, dtype=torch.float64)) @ q.T).float()
mask = (torch.arange(T, device=dev) < LIVE).float()
carry = (k_tt, torch.tensor(0.01, device=dev), mask)
matvec = iterative.make_gram_matvec_block()


def solve(b, graphed):
    profiling.reset()
    profiling.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if graphed:
            res = linalg._chunked_cg_rows(matvec, carry, b, 0.0, ITERS, None,
                                          linalg.GRAPH_CHUNK, graphed=True)
        else:
            res = linalg._batched_cg_rows(matvec, carry, b, 0.0, ITERS, None, None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        syncs = profiling.snapshot()["counts"]["host.syncs"]
    finally:
        profiling.disable()
        profiling.reset()
    return res, seconds, syncs


for rows in (1, 16):
    b = torch.randn((rows, T), generator=gen, device=dev) * mask
    ref, _, _ = solve(b, False)
    got, _, _ = solve(b, True)  # captures the graph
    same = (got.iterations == ref.iterations == ITERS and torch.equal(got.x, ref.x)
            and torch.equal(got.residual_norm, ref.residual_norm))
    times = {False: [], True: []}
    syncs = {}
    for graphed in (False, True, True, False) * REPEATS:
        _, seconds, syncs[graphed] = solve(b, graphed)
        times[graphed].append(seconds)
    loop_ms = 1e3 * statistics.median(times[False]) / ITERS
    graph_ms = 1e3 * statistics.median(times[True]) / ITERS
    cs.log(f"B = {rows}: {ITERS} iterations; loop {loop_ms:.4f} ms an iteration, "
           f"{syncs[False]} host reads; graph {graph_ms:.4f} ms an iteration, "
           f"{syncs[True]} host reads; {loop_ms / graph_ms:.2f}x; "
           f"graph == loop bit for bit: {same}")
    if not same:
        raise SystemExit("the graph path differs from the one-iteration loop")
