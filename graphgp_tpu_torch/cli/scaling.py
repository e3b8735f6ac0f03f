"""Scaling experiment: random-walk sampling throughput, and GP train
and predict times, across ring-graph sizes.

Counterpart of ``graphgp_tpu/cli/scaling.py``: a size sweep on ring graphs,
phase flags (--rw-only / --gp-only / --exact-only), CSV results with
timestamped copies. The iterative arm fits by CG + SLQ on the stencil layout
and predicts by pathwise conditioning, in the full node space when the train
set is at least an eighth of the graph (the fused masked-Gram CG, kernel K2);
the exact arm densifies the ELL step matrices and fits by L-BFGS on the
Cholesky marginal likelihood.

Every timed call is made twice. The second call's seconds are the reported
time; the "compile" columns keep the JAX package's names and hold first-call
minus second-call seconds: here that is one-time work of the first call
(kernel build and load, CUDA library initialization, allocator growth), not
compilation. A failing size raises: there is no error row that hides a
failure.

Usage:
    python -m graphgp_tpu_torch.cli.scaling --sizes 1024 4096 --walks-per-node 100
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np

from ..utils.config import add_config_flag, parse_with_config


def _walk_config(args):
    from ..walker import WalkConfig

    return WalkConfig(
        walks_per_node=args.walks_per_node, p_halt=args.p_halt,
        max_walk_length=args.max_walk_length,
    )


def _timed(fn, dev):
    """(result, seconds) of ``fn()``, the device's queued work included."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def run_rw_phase(sizes, args, records) -> None:
    from ..data.synthetic import generate_ring_data
    from ..devices import resolve_device
    from ..graphs import pack_laplacian
    from ..pipeline import blocked_ell_features
    from ..utils.profiling import walks_per_second
    from ..walker import sample_dense_step_matrices

    dev = resolve_device(args.device)
    cfg = _walk_config(args)
    for n in sizes:
        data = generate_ring_data(n, seed=args.seed)
        graph = pack_laplacian(data["adjacency"]).to(dev)
        # Timed quantity: the full kernel build (walk + consolidation into ELL
        # step matrices). The first call also probes the row capacity.
        feats, cold = _timed(lambda: blocked_ell_features(graph, args.seed, cfg, device=dev), dev)
        feats, dt = _timed(
            lambda: blocked_ell_features(
                graph, args.seed + 1, cfg, capacity=feats.mats.row_capacity, device=dev
            ),
            dev,
        )
        mats = feats.mats
        nnz = int(mats.nnz())
        dense_bytes = cfg.max_walk_length * n * n * 4
        ell_bytes = int(np.prod(mats.cols.shape)) * 8
        rec = {
            "phase": "rw",
            "n_nodes": n,
            "walks_per_node": cfg.walks_per_node,
            "rw_seconds": dt,
            "rw_compile_seconds": max(cold - dt, 0.0),
            "walks_per_s": walks_per_second(n, cfg.walks_per_node, dt),
            "nnz": nnz,
            "ell_mb": ell_bytes / 1e6,
            "compression_vs_dense": dense_bytes / max(ell_bytes, 1),
        }
        # dense-vs-sparse comparison at small N (the reference protocol runs
        # the dense sampler only for 2^5..2^10)
        if n <= args.dense_rw_max:
            _timed(lambda: sample_dense_step_matrices(graph, args.seed, cfg), dev)
            _, dense_dt = _timed(lambda: sample_dense_step_matrices(graph, args.seed + 1, cfg), dev)
            rec["dense_rw_seconds"] = dense_dt
            rec["sparse_speedup_vs_dense"] = dense_dt / max(dt, 1e-9)
        records.append(rec)
        print(
            f"[rw] n={n}: {dt:.3f}s (first call +{rec['rw_compile_seconds']:.1f}s)  "
            f"{rec['walks_per_s']:,.0f} walks/s  "
            f"nnz={nnz}  {rec['ell_mb']:.1f}MB (x{rec['compression_vs_dense']:.0f} vs dense)"
        )


def run_gp_phase(sizes, args, records, exact_mode: bool = False) -> None:
    import torch

    from ..data.synthetic import generate_ring_data
    from ..devices import resolve_device
    from ..features import DenseFeatures, ell_to_dense
    from ..gp import exact as gp_exact
    from ..gp import iterative
    from ..preprocessor import preprocess_graph

    dev = resolve_device(args.device)
    cfg = _walk_config(args)
    settings = iterative.CGSettings(cg_tol=args.cg_tol, cg_max_iters=100, num_probes=16)
    for n in sizes:
        data = generate_ring_data(n, seed=args.seed)
        # iterative arm: layout="auto" gives the stencil layout on these ring
        # graphs; the exact arm needs the ELL matrices to densify
        feats = preprocess_graph(
            data["adjacency"], cfg, seed=args.seed, cache_dir=args.cache_dir,
            layout="ell" if exact_mode else "auto", device=dev,
        )
        if exact_mode:
            feats = DenseFeatures(ell_to_dense(feats.mats))
        perm = np.random.default_rng(args.seed).permutation(n)
        tr = torch.from_numpy(np.sort(perm[: n // 2])).to(dev)
        te = torch.from_numpy(np.sort(perm[n // 2 :])).to(dev)
        y = torch.from_numpy(data["y_observed"]).to(dev)
        y_true = torch.from_numpy(data["y_true"]).to(dev)

        def run_fit(seed):
            gen = torch.Generator(device=dev).manual_seed(seed)
            if exact_mode:
                # L-BFGS, as the reference's dense arm
                return gp_exact.fit(
                    feats, tr, y[tr], kind="free", num_steps=args.train_epochs,
                    learning_rate=args.learning_rate, optimizer="lbfgs", generator=gen,
                )
            return iterative.fit(
                feats, tr, y[tr], kind="free", num_steps=args.train_epochs,
                learning_rate=args.learning_rate, settings=settings, generator=gen,
            )

        def run_predict(res, seed):
            if exact_mode:
                return gp_exact.predict(feats, res.params, tr, y[tr], te, kind="free").mean
            samples = iterative.pathwise_predict(
                feats, res.params, tr, y[tr], te, kind="free",
                num_samples=args.num_pathwise_samples, settings=settings,
                # dense train sets take the scatter-free full-space solver
                # (the same rule as iterative.fit)
                full_space=bool(tr.shape[0] * 8 >= n),
                generator=torch.Generator(device=dev).manual_seed(seed),
            )
            return iterative.summarize_samples(samples).mean

        res, train_cold = _timed(lambda: run_fit(args.seed), dev)
        res, train_s = _timed(lambda: run_fit(args.seed + 1), dev)
        mean, predict_cold = _timed(lambda: run_predict(res, 0), dev)
        mean, predict_s = _timed(lambda: run_predict(res, 1), dev)
        rmse = float(torch.sqrt(((mean - y_true[te]) ** 2).mean()))
        phase = "exact_gp" if exact_mode else "iterative_gp"
        records.append(
            {
                "phase": phase,
                "n_nodes": n,
                "train_seconds": train_s,
                "train_compile_seconds": max(train_cold - train_s, 0.0),
                "predict_seconds": predict_s,
                "predict_compile_seconds": max(predict_cold - predict_s, 0.0),
                "rmse": rmse,
                "final_loss": float(res.losses[-1]),
            }
        )
        print(
            f"[{phase}] n={n}: train {train_s:.2f}s "
            f"(first call +{max(train_cold - train_s, 0.0):.1f}s) "
            f"predict {predict_s:.2f}s rmse {rmse:.4f}"
        )


def fit_exponents(records: List[Dict]) -> List[Dict]:
    """Log-log least-squares exponents of the steady times over n ≥ 4096
    (where fixed per-call overheads no longer dominate); one record per
    (phase, field) with at least three points."""
    out = []
    for phase, field in (
        ("rw", "rw_seconds"),
        ("iterative_gp", "train_seconds"),
        ("iterative_gp", "predict_seconds"),
    ):
        pts = [
            (r["n_nodes"], r[field])
            for r in records
            if r.get("phase") == phase and field in r and r["n_nodes"] >= 4096 and r[field] > 0
        ]
        if len(pts) < 3:
            continue
        ln = np.log(np.asarray([p[0] for p in pts], np.float64))
        lt = np.log(np.asarray([p[1] for p in pts], np.float64))
        slope, _ = np.polyfit(ln, lt, 1)
        out.append({
            "phase": "fit_exponent",
            "target_phase": phase,
            "field": field,
            "exponent": float(slope),
            "n_min": int(min(p[0] for p in pts)),
            "n_max": int(max(p[0] for p in pts)),
            "n_points": len(pts),
        })
        print(f"[exponent] {phase}.{field}: t ~ N^{slope:.3f} "
              f"(reference claim for GP inference: N^1.5) over N={pts[0][0]}..{pts[-1][0]}")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_flag(p)
    p.add_argument("--sizes", type=int, nargs="+", default=[256, 1024, 4096])
    p.add_argument("--gp-sizes", type=int, nargs="+", default=None,
                   help="sizes for the GP phases (default: same as --sizes)")
    p.add_argument("--walks-per-node", type=int, default=100)
    p.add_argument("--p-halt", type=float, default=0.1)
    p.add_argument("--max-walk-length", type=int, default=3)
    p.add_argument("--train-epochs", type=int, default=50)
    p.add_argument("--learning-rate", type=float, default=0.1)
    p.add_argument("--cg-tol", type=float, default=1e-2)
    p.add_argument("--num-pathwise-samples", type=int, default=64)
    p.add_argument("--dense-rw-max", type=int, default=1024,
                   help="run the dense sampler comparison for n <= this")
    p.add_argument("--exact-max", type=int, default=1024,
                   help="exact (Cholesky) GP arm size cap")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--rw-only", action="store_true")
    p.add_argument("--gp-only", action="store_true")
    p.add_argument("--exact-only", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--results-dir", default="artifacts/results")
    p.add_argument("--cache-dir", default="artifacts/step_matrices")
    return p


def main(argv=None) -> List[Dict]:
    args, _cfg = parse_with_config(build_parser(), argv)

    from ..devices import resolve_device
    from ..utils.io import save_results

    resolve_device(args.device)
    records: List[Dict] = []
    do_all = not (args.rw_only or args.gp_only or args.exact_only)
    gp_sizes = args.gp_sizes or args.sizes
    if args.rw_only or do_all:
        run_rw_phase(args.sizes, args, records)
    if args.gp_only or do_all:
        run_gp_phase(gp_sizes, args, records, exact_mode=False)
    if args.exact_only or do_all:
        run_gp_phase([n for n in gp_sizes if n <= args.exact_max], args, records, exact_mode=True)
    records.extend(fit_exponents(records))

    path = save_results(records, args.results_dir, "scaling", config=vars(args))
    print(f"results -> {path}")
    return records


if __name__ == "__main__":
    main()
