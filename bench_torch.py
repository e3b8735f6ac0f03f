#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (graphgp_tpu_torch) on one CUDA card.

The port's counterpart of ``bench.py``, at the same four shapes:

  * kernel build (walk + ELL consolidation) at N = 1e6 grid,
    walks_per_node = 1000, p_halt = 0.1, L = 5, through the blocked pipeline;
  * walk throughput at N = 2^20 ring, walks_per_node = 100, L = 3;
  * ELL → stencil conversion seconds on the kernel build's step matrices;
  * CG iterations/s on the N = 1e6 Gram solve (n_train = N/2, batch of 8
    right-hand sides, 20 iterations at tol 0) through the fused masked-Gram CG
    (kernel K2), and beside it through the composition it replaces
    (``batched_cg`` over ``make_gram_matvec_bm_full``, two K1 launches an
    iteration);
  * dense step matrices per second through the fused walk kernel (K4) at a
    64 x 32 grid (N = 2048), walks_per_node = 1024, L = 10: the dense
    regime's sampler, which ``bench.py`` does not time.

Every metric is printed as its own JSON line the moment it is measured, each
with the card's name and power limit; the last line is the headline record
with the other metrics under ``extra_metrics``. There is no ``vs_baseline``:
the port's numbers are not set against records taken on other hardware.

Usage: python3 bench_torch.py   (exits non-zero without a CUDA card)
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

CG_ITERS = 20
CG_BATCH = 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def emit(card: str, metric: str, value: float, unit: str, **extra) -> dict:
    rec = {"metric": metric, "value": value, "unit": unit, "card": card}
    rec.update(extra)
    print(json.dumps(rec), flush=True)
    return rec


def best_seconds(fn, reps: int) -> float:
    """Least wall seconds of ``reps`` calls, each ended by a device synchronize."""
    import torch

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_kernel_build(device):
    """Full kernel build (walk + consolidate) at N = 1e6, wpn = 1000, L = 5."""
    from graphgp_tpu_torch import WalkConfig, blocked_ell_features, pack_laplacian
    from graphgp_tpu_torch.data import synthetic

    graph = pack_laplacian(synthetic.generate("grid", 1_000_000, seed=0)["adjacency"]).to(device)
    cfg = WalkConfig(walks_per_node=1000, p_halt=0.1, max_walk_length=5)
    # the first build probes the row capacity; the timed builds reuse it
    feats = blocked_ell_features(graph, 0, cfg, device=device)
    cap = feats.mats.row_capacity
    del feats
    out = {}

    def run():
        out["feats"] = None  # free the previous build before the next one allocates
        out["feats"] = blocked_ell_features(graph, 1, cfg, capacity=cap, device=device)

    return best_seconds(run, reps=2), out["feats"]


def bench_walk_throughput(device) -> float:
    from graphgp_tpu_torch import WalkConfig, pack_laplacian, sample_walk_log
    from graphgp_tpu_torch.data.synthetic import generate_ring_data

    n = 2**20
    cfg = WalkConfig(walks_per_node=100, p_halt=0.1, max_walk_length=3)
    graph = pack_laplacian(generate_ring_data(n)["adjacency"]).to(device)
    sample_walk_log(graph, 0, cfg)  # warm
    seeds = iter(range(1, 100))
    dt = best_seconds(lambda: sample_walk_log(graph, next(seeds), cfg), reps=3)
    return n * cfg.walks_per_node / dt


def bench_stencil_convert(feats):
    """Offset vocabulary + kernel K3 on the kernel build's ELL step matrices."""
    import torch

    from graphgp_tpu_torch.features import StencilFeatures, ell_to_stencil

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stencil = ell_to_stencil(feats.mats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if stencil is None:
        raise RuntimeError("the grid's offset vocabulary exceeded the stencil limit")
    return dt, StencilFeatures(stencil)


def bench_cg(sfeats, device) -> dict:
    """CG iterations/s on the 1e6-node full-space masked Gram solve."""
    import torch

    from graphgp_tpu_torch.cuda_kernels import gram
    from graphgp_tpu_torch.features import contract
    from graphgp_tpu_torch.gp import params as P
    from graphgp_tpu_torch.gp.iterative import make_gram_matvec_bm_full
    from graphgp_tpu_torch.linalg import batched_cg

    n = sfeats.num_nodes
    params = P.init_params("diffusion", sfeats.max_walk_length, noise=0.1, device=device)
    with torch.no_grad():
        phi = contract(sfeats, P.modulator("diffusion", params, sfeats.max_walk_length))
        noise_var = P.noise_variance(params)
    mask = torch.zeros(n, device=device)
    mask[::2] = 1.0
    gen = torch.Generator(device=device).manual_seed(1)
    b = torch.randn((CG_BATCH, n), generator=gen, device=device) * mask[None, :]
    matvec = make_gram_matvec_bm_full()

    def fused():
        return gram.gram_cg(phi, noise_var, mask, b, tol=0.0, max_iters=CG_ITERS)

    def composed():
        with torch.no_grad():
            return batched_cg(matvec, (phi, noise_var, mask), b, tol=0.0, max_iters=CG_ITERS)

    x_f, x_c = fused().x, composed().x  # warm both
    rel = float((x_f - x_c).abs().max() / x_c.abs().max())
    if not rel <= 1e-3:
        raise RuntimeError(f"fused CG and the K1 composition disagree: rel {rel}")
    # in turns, so both see the same card state
    t_c1 = best_seconds(composed, reps=2)
    t_f = best_seconds(fused, reps=4)
    t_c = min(t_c1, best_seconds(composed, reps=2))
    s = phi.w.shape[0]
    # bytes the fused iteration must move: K2a 4(SN + 2BN + N), K2b
    # 4(SN + 3BN + N), and the vector updates of x, r, p (~10 BN floats)
    bytes_per_iter = 4 * (2 * s * n + 15 * CG_BATCH * n + 2 * n)
    return {"fused": CG_ITERS / t_f, "composed": CG_ITERS / t_c, "rel": rel,
            "num_offsets": s, "bytes_per_iter": bytes_per_iter}


def bench_dense_walk(device) -> dict:
    """(L, N, N) step matrices per second through kernel K4 at N = 2048
    (a 64 x 32 grid), walks_per_node = 1024, p_halt = 0.1, L = 10."""
    import scipy.sparse as sp

    from graphgp_tpu_torch import WalkConfig, pack_laplacian
    from graphgp_tpu_torch.cuda_kernels import walker as k4

    rows, cols = 64, 32
    path = lambda m: sp.diags([1.0, 1.0], [-1, 1], shape=(m, m))
    adj = (sp.kron(sp.eye(rows), path(cols)) + sp.kron(path(rows), sp.eye(cols))).tocsr()
    graph = pack_laplacian(adj).to(device)
    cfg = WalkConfig(walks_per_node=1024, p_halt=0.1, max_walk_length=10)
    k4.sample_dense_step_matrices_cuda(graph, 0, cfg)  # warm
    seeds = iter(range(1, 100))
    dt = best_seconds(lambda: k4.sample_dense_step_matrices_cuda(graph, next(seeds), cfg), reps=5)
    return {"per_s": 1.0 / dt, "walks_per_s": graph.num_nodes * cfg.walks_per_node / dt}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; this benchmark runs only on a GPU", file=sys.stderr)
        return 2
    device = "cuda:0"
    torch.cuda.set_device(0)
    card = card_line()
    from graphgp_tpu_torch.cuda_kernels import _build

    t0 = time.perf_counter()
    _build.load()
    emit(card, "cuda_kernels_build", round(time.perf_counter() - t0, 2), "s")

    build_s, feats = bench_kernel_build(device)
    headline = emit(card, "grf_kernel_build_n1M_wpn1000_L5", round(build_s, 3), "s",
                    row_capacity=feats.mats.row_capacity)
    walks = bench_walk_throughput(device)
    m_walk = emit(card, "grf_walk_throughput_n1M_wpn100_L3", round(walks, 1), "walks/s/chip")
    convert_s, sfeats = bench_stencil_convert(feats)
    del feats
    m_conv = emit(card, "ell_to_stencil_convert_n1M_L5", round(convert_s, 4), "s",
                  num_offsets=int(sfeats.mats.num_offsets))
    cg = bench_cg(sfeats, device)
    m_cg = emit(card, "cg_iters_per_s_n1M_ntrain500k_b8", round(cg["fused"], 2), "iters/s",
                path="fused masked-Gram CG (K2a + K2b per iteration)",
                rel_diff_vs_k1_composition=cg["rel"])
    m_cg_k1 = emit(card, "cg_iters_per_s_n1M_ntrain500k_b8_k1_composition",
                   round(cg["composed"], 2), "iters/s",
                   path="batched_cg over make_gram_matvec_bm_full (two K1 launches per iteration)")
    m_bw = emit(card, "cg_hbm_gb_per_s_n1M_b8",
                round(cg["bytes_per_iter"] * cg["fused"] / 1e9, 1), "GB/s",
                bytes_per_iter_model=cg["bytes_per_iter"], num_offsets=cg["num_offsets"])

    dense = bench_dense_walk(device)
    m_dense = emit(card, "dense_step_matrices_per_s_n2048_wpn1024_L10", round(dense["per_s"], 2),
                   "step-matrix sets/s", path="fused walk kernel (K4), one launch per set",
                   walks_per_s=round(dense["walks_per_s"], 1))

    headline = dict(headline)
    headline["extra_metrics"] = [m_walk, m_conv, m_cg, m_cg_k1, m_bw, m_dense]
    print(json.dumps(headline), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
