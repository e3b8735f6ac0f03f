"""Multiclass node classification with SVGP on GRF kernels (Cora protocol).

Counterpart of ``graphgp_tpu/cli/classification.py`` (the reference's Cora
study: SVGP, MultiClass likelihood, inducing points = half the train nodes,
whitened, Adam lr 0.003 × 1000, 5 seeds; GRF walks_per_node 4096, L 5,
p_halt 0.1; the full 80/20 and the "small" 140-train splits; an
exact-diffusion kernel arm for comparison).

Runs on the real Cora files when ``--cora-dir`` holds ``cora.cites`` /
``cora.content`` (they are not in the repository and nothing is downloaded),
else on a synthetic community graph. GRF step matrices come from
``kernels.features_for_adjacency``: on the card, the fused walk kernel (K4).
Seeds follow the JAX CLI: walks from ``42 + seed``, the two fit restarts'
initial draws from 42 and ``1000 + seed``, the inducing points from
``default_rng(seed)``.

Usage:
    python -m graphgp_tpu_torch.cli.classification --n-nodes 400 --num-classes 4
    python -m graphgp_tpu_torch.cli.classification --device cpu --n-nodes 200 --num-classes 3 \\
        --walks-per-node 200 --max-walk-length 3 --num-steps 200 --seeds 1
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np

from ..utils.config import add_config_flag, parse_with_config


def synthetic_community_graph(n_nodes, num_classes, seed, p_in=0.05, p_out=0.002):
    """Stochastic block model whose class labels are the community ids."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n_nodes).astype(np.int32)
    rows, cols = [], []
    # drawn block by block, O(E)
    for c in range(num_classes):
        members = np.flatnonzero(labels == c)
        m = members.size
        n_in = rng.binomial(m * (m - 1) // 2, p_in)
        if n_in and m > 1:
            a = members[rng.integers(0, m, n_in)]
            b = members[rng.integers(0, m, n_in)]
            rows.extend(a.tolist())
            cols.extend(b.tolist())
    n_out = rng.binomial(n_nodes * (n_nodes - 1) // 2, p_out)
    a = rng.integers(0, n_nodes, n_out)
    b = rng.integers(0, n_nodes, n_out)
    rows.extend(a.tolist())
    cols.extend(b.tolist())
    rows, cols = np.asarray(rows), np.asarray(cols)
    keep = rows != cols
    adj = sp.csr_matrix(
        (np.ones(keep.sum()), (rows[keep], cols[keep])), shape=(n_nodes, n_nodes)
    )
    adj = adj + adj.T
    adj.data[:] = 1.0
    return adj.tocsr(), labels


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_flag(p)
    p.add_argument("--cora-dir", default=None,
                   help="directory with cora.cites/cora.content (real protocol)")
    p.add_argument("--n-nodes", type=int, default=400)
    p.add_argument("--num-classes", type=int, default=4)
    p.add_argument("--train-frac", type=float, default=0.8)
    p.add_argument("--small-train", type=int, default=0,
                   help="if >0, use this many train nodes (the 140-train 'small' split)")
    p.add_argument("--num-test", type=int, default=0,
                   help="if >0, test on this many non-train nodes (the reference's "
                        "small/diff protocols test on 1000)")
    p.add_argument("--num-inducing", type=int, default=0,
                   help="inducing point count (default: train/2; the reference's "
                        "small/diff protocols use M=50)")
    p.add_argument("--walks-per-node", type=int, default=1024)
    p.add_argument("--p-halt", type=float, default=0.1)
    p.add_argument("--max-walk-length", type=int, default=5)
    p.add_argument("--kernel-kind", default="free",
                   choices=["free", "diffusion", "exact_diffusion"],
                   help="free/diffusion = GRF features; exact_diffusion = the exact "
                        "sigma_f^2 expm(-beta L) kernel through the spectral adapter")
    p.add_argument("--likelihood", default="robustmax", choices=["robustmax", "softmax"],
                   help="robustmax = the reference's MultiClass/RobustMax likelihood with "
                        "analytic Gauss-Hermite expectations; softmax = Monte-Carlo ELBO")
    p.add_argument("--learning-rate", type=float, default=3e-3)
    p.add_argument("--num-steps", type=int, default=1000)
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--resplit-per-seed", action="store_true",
                   help="draw a fresh train/test split per seed (default: one fixed "
                        "split from seed 1 for every seed, the reference protocol)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--results-dir", default="artifacts/results")
    return p


def main(argv=None) -> List[Dict]:
    args, _cfg = parse_with_config(build_parser(), argv)

    import torch

    from ..devices import resolve_device
    from ..gp import spectral, svgp
    from ..kernels import features_for_adjacency
    from ..utils.io import print_summary, save_results

    dev = resolve_device(args.device)
    records: List[Dict] = []
    for seed in range(args.seeds):
        split_seed = seed if args.resplit_per_seed else 1
        if args.cora_dir:
            from ..data.database import load_cora

            # the split sizes go to the loader, whose train set is a random
            # subset of its permutation: the lowest 140 node ids would be
            # nearly all one class
            adj, labels, tr_np, te_np = load_cora(
                args.cora_dir, num_train=args.small_train or 1988,
                num_test=args.num_test or 497, seed=split_seed,
            )
            n = adj.shape[0]
            num_classes = int(labels.max()) + 1
        else:
            adj, labels = synthetic_community_graph(args.n_nodes, args.num_classes, seed)
            n = args.n_nodes
            num_classes = args.num_classes
            perm = np.random.default_rng(seed).permutation(n)
            n_tr = args.small_train or int(n * args.train_frac)
            tr_np = np.sort(perm[:n_tr])
            te_np = np.sort(perm[n_tr:])
            if args.num_test:
                pool = np.setdiff1d(np.arange(n), tr_np)
                rng_te = np.random.default_rng(1000 + split_seed)
                te_np = np.sort(rng_te.choice(pool, min(args.num_test, pool.size), replace=False))
        tr = torch.from_numpy(np.asarray(tr_np, np.int64)).to(dev)
        te = torch.from_numpy(np.asarray(te_np, np.int64)).to(dev)
        y = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
        # Inducing points: a per-seed random subset of the train nodes (the
        # reference's Z = x_train[np.random.choice(train_num, M)] under
        # np.random.seed(seed)), the main source of seed-to-seed variation.
        m_ind = args.num_inducing or max(1, tr_np.size // 2)
        inducing_np = np.sort(np.random.default_rng(seed).choice(
            tr_np, min(m_ind, tr_np.size), replace=False))
        inducing = torch.from_numpy(np.asarray(inducing_np, np.int64)).to(dev)

        if args.kernel_kind == "exact_diffusion":
            feats = spectral.SpectralDiffusionFeatures(spectral.eigenbasis(adj, device=dev))
        else:
            feats = features_for_adjacency(
                adj, 42 + seed, walks_per_node=args.walks_per_node, p_halt=args.p_halt,
                max_walk_length=args.max_walk_length, device=dev,
            )

        # Two restarts (initial draws from 42 and 1000 + seed), keeping the
        # lower final loss: a free modulator's draw occasionally lands in a
        # bad basin, and no single fixed draw is safe for every seed.
        res = None
        for init_seed in (42, 1000 + seed):
            r = svgp.fit(
                feats, inducing, tr, y[tr], num_latent=num_classes, kind=args.kernel_kind,
                likelihood=args.likelihood,
                generator=torch.Generator(device=dev).manual_seed(init_seed),
                learning_rate=args.learning_rate, num_steps=args.num_steps,
            )
            if res is None or float(r.losses[-1]) < float(res.losses[-1]):
                res = r
        probs = svgp.predict_class_probs(
            feats, res.params, inducing, te, kind=args.kernel_kind, likelihood=args.likelihood,
            generator=torch.Generator(device=dev).manual_seed(seed),
        )
        pred = svgp.predict_class(feats, res.params, inducing, te, kind=args.kernel_kind,
                                  likelihood=args.likelihood)
        acc = float(torch.mean((pred == y[te]).float()))
        true_probs = probs.cpu().numpy()[np.arange(te.shape[0]), y[te].cpu().numpy()]
        nll = float(-np.log(np.maximum(true_probs, 1e-12)).mean())
        rec = {
            "seed": seed, "accuracy": acc, "test_nll": nll,
            "final_elbo": -float(res.losses[-1]),
            "n_train": int(tr.shape[0]), "n_test": int(te.shape[0]),
            "kernel": args.kernel_kind, "likelihood": args.likelihood,
            "num_inducing": int(inducing.shape[0]),
        }
        records.append(rec)
        print(f"seed={seed}: accuracy={acc:.4f} nll={nll:.4f} elbo={rec['final_elbo']:.1f}")

    path = save_results(records, args.results_dir, "classification", config=vars(args))
    print_summary(records, ["kernel"], ["accuracy", "test_nll"])
    print(f"results -> {path}")
    return records


if __name__ == "__main__":
    main()
