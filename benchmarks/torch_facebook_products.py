#!/usr/bin/env python3
"""The facebook BO path's products on the card, with variants and yardsticks.

On the shipped facebook graph (``processed_data/facebook.npz``, N = 22470)
at the BO cell's walks (walks_per_node 500, p_halt 0.1, L 5, walk seed 42):
preprocessing seconds by phase (walk + consolidate, the offset scan that
rules the stencil out, the column-sorted transpose on the card, and the same
transpose built from host tensors), then at B = 1, 8, 16 and 17 the mean ms
(CUDA events around REPS back-to-back calls) of

  * the ELL forward product ``V Φᵀ`` (``features.ell_phi_matvec_bm``, one
    ``embedding_bag`` sum a step) and variants of its step: int64 indices in
    place of int32; the (N·R, B) rows of vᵀ gathered by ``index_select``
    and reduced by a batched (1, R) @ (R, B) product, with the rows as they
    are or padded to a width that is not a multiple of 4 floats (rows of a
    multiple of 4 floats take a slow ``index_select`` path in torch 2.11);
    the batch-major rows of v gathered (``v.index_select(1, idx)``),
    multiplied and summed;
  * the transposed product ``V Φ`` through the transpose
    (``features.csc_phi_rmatvec_bm``), the same variants, and the scatter-add
    version it replaces (``features.ell_phi_rmatvec_bm``, float atomics on
    the card);
  * ``torch.sparse.mm`` with Φ (or Φᵀ) as one CSR matrix, the library call
    that computes the same function;

each beside its byte bound (every array the function reads, once, and its
output, once, at 3.35 TB/s), and whether two calls of the shipped products
give the same bits.

Usage: python3 benchmarks/torch_facebook_products.py   (needs a CUDA card; run from the repo's root)
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 10
HBM_BYTES_PER_S = 3.35e12
F = (1.0, 0.7, -0.4, 0.25, 0.1)


def ms(fn, reps=REPS):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_facebook_products: no CUDA device", file=sys.stderr)
        return 2
    from graphgp_tpu_torch import features as tf
    from graphgp_tpu_torch.data.database import GraphDataLoader
    from graphgp_tpu_torch.preprocessor import preprocess_graph
    from graphgp_tpu_torch.walker import WalkConfig

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        data = GraphDataLoader(data_root=root, cache_dir="processed_data")("facebook")
    trace: dict = {}
    feats = preprocess_graph(data["adjacency"], WalkConfig(500, 0.1, 5), seed=42, cache_dir=None,
                             layout="auto", device=dev, trace=trace)
    mats, csc = feats.mats, feats.csc
    l, n, r = mats.cols.shape
    nt = mats.num_target_nodes
    ell_bytes = mats.cols.numel() * 4 + mats.vals.numel() * 4
    print(f"N={n} L={l} R={r}; ELL {ell_bytes / 1e6:.1f} MB, live {int(mats.nnz())}; transpose "
          f"{csc.nbytes() / 1e6:.1f} MB, used virtual rows {list(csc.used_vrows)}")
    print(f"walk+consolidate {trace['walk_consolidate_s']:.3f} s, offset scan "
          f"{trace['vocabulary_s']:.3f} s, transpose on the card {trace['transpose_s']:.3f} s")
    host = mats.to("cpu")
    t0 = time.perf_counter()
    host_csc = tf.transpose_ell(host)
    fields = ("rows", "vals", "seg_start", "last_pos", "has_any")
    same = all(torch.equal(getattr(host_csc, k), getattr(csc, k).cpu()) for k in fields)
    print(f"transpose from host tensors {time.perf_counter() - t0:.3f} s, equal to the card's: "
          f"{same}")
    del host, host_csc

    f = torch.tensor(F, device=dev)
    blk = tf.CSC_BLOCK
    used = csc.used_vrows

    def gather_reduce(idx, w, vt, v, how):
        """Σ_k w[j, k] · x[idx[j, k]] for each row j of (J, K) idx / w: (J, B)."""
        jj, kk = idx.shape
        if how == "int64 indices":
            return tf._bag_sums(idx.to(torch.int64), w, vt)
        if how == "batch-major":
            return (v.index_select(1, idx.reshape(-1)).view(-1, jj, kk) * w).sum(-1).T
        b = vt.shape[1]
        if how == "gather at an odd width + bmm" and b % 4 == 0:
            vt = torch.nn.functional.pad(vt, (0, 1))
        g = vt.index_select(0, idx.reshape(-1)).view(jj, kk, -1)
        return torch.bmm(w.unsqueeze(1), g).view(jj, -1)[:, :b]

    def ell_variant(v, how):
        vt = v.T.contiguous()
        acc = torch.zeros((n, v.shape[0]), device=dev)
        for li in range(l):
            acc = acc + f[li] * gather_reduce(mats.cols[li], mats.vals[li], vt, v, how)
        return acc.T.contiguous()

    def csc_variant(v, how):
        vt = v.T.contiguous()
        acc = torch.zeros((nt, v.shape[0]), device=dev)
        for li in range(l):
            u = used[li]
            part = gather_reduce(csc.rows[li].reshape(-1)[: u * blk].view(u, blk),
                                 csc.vals[li].reshape(-1)[: u * blk].view(u, blk), vt, v, how)
            acc = acc + f[li] * torch.segment_reduce(part, "sum", offsets=csc.vrow_ptr[li], axis=0)
        return acc.T.contiguous()

    # the library yardstick: Φ = Σ_l f_l M_l as one CSR matrix (built once, untimed)
    row_ix = torch.arange(n, device=dev).repeat_interleave(r)
    coo = torch.sparse_coo_tensor(
        torch.stack([row_ix.repeat(l), mats.cols.reshape(-1).to(torch.int64)]),
        (f[:, None, None] * mats.vals).reshape(-1), (n, nt)).coalesce()
    phi_csr = coo.to_sparse_csr()
    phit_csr = coo.t().coalesce().to_sparse_csr()
    del coo, row_ix

    live_vrow_bytes = sum(used) * blk * 8 + csc.vrow_ptr.numel() * 8
    for b in (1, 8, 16, 17):
        vt_in = torch.randn((b, nt), device=dev)
        vs_in = torch.randn((b, n), device=dev)
        fwd_bound = (ell_bytes + 4 * b * (nt + n)) / HBM_BYTES_PER_S * 1e3
        csc_bound = (live_vrow_bytes + 4 * b * (n + nt)) / HBM_BYTES_PER_S * 1e3
        a1 = tf.ell_phi_matvec_bm(mats, f, vt_in)
        same_fwd = torch.equal(a1, tf.ell_phi_matvec_bm(mats, f, vt_in))
        c1 = tf.csc_phi_rmatvec_bm(csc, f, vs_in)
        same_csc = torch.equal(c1, tf.csc_phi_rmatvec_bm(csc, f, vs_in))
        scat = tf.ell_phi_rmatvec_bm(mats, f, vs_in)
        lib_fwd = torch.sparse.mm(phi_csr, vt_in.T).T
        lib_t = torch.sparse.mm(phit_csr, vs_in.T).T
        err = lambda x, y: float((x - y).abs().max() / y.abs().max())
        variants = ("int64 indices", "gather + bmm", "gather at an odd width + bmm",
                    "batch-major")
        fwd = {h: ms(lambda: ell_variant(vt_in, h)) for h in variants}
        tra = {h: ms(lambda: csc_variant(vs_in, h)) for h in variants}
        print(f"B={b}: ELL forward {ms(lambda: tf.ell_phi_matvec_bm(mats, f, vt_in)):.4f} ms "
              f"(variants {', '.join(f'{h} {t:.4f}' for h, t in fwd.items())}; "
              f"sparse.mm {ms(lambda: torch.sparse.mm(phi_csr, vt_in.T)):.4f}), "
              f"bound {fwd_bound:.4f} ms (bytes), repeat equal {same_fwd}, "
              f"vs sparse.mm {err(a1, lib_fwd):.2e}")
        print(f"B={b}: transposed {ms(lambda: tf.csc_phi_rmatvec_bm(csc, f, vs_in)):.4f} ms "
              f"(variants {', '.join(f'{h} {t:.4f}' for h, t in tra.items())}; scatter-add "
              f"{ms(lambda: tf.ell_phi_rmatvec_bm(mats, f, vs_in)):.4f}; sparse.mm "
              f"{ms(lambda: torch.sparse.mm(phit_csr, vs_in.T)):.4f}), bound {csc_bound:.4f} ms "
              f"(bytes), repeat equal {same_csc}, vs scatter {err(c1, scat):.2e}, "
              f"vs sparse.mm {err(c1, lib_t):.2e}", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
