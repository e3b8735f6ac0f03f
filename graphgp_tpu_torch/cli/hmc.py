"""HMC over GRF-GP hyperparameter posteriors.

Counterpart of ``graphgp_tpu/cli/hmc.py``: samples the posterior over the
kernel hyperparameters (β, σ_f and the noise for the diffusion kernel, or the
modulator vector for the free kernel) with Laplace-whitened HMC chains and
dual-averaging warmup, then reports split-R̂, accept rates and
posterior-averaged predictive metrics beside the ML-II point estimate.

Same flags, defaults, split and seeds as the JAX CLI: walks from seed 42
(on the card, the fused walk kernel K4, bit-identical walks), 200 Adam
steps of ML-II, an L-BFGS polish of the log posterior's mode, chains from
generator seed 0. One flag more, ``--step-jitter`` (default 0.1): each
iteration's leapfrog step is drawn within ±10% of the adapted one. With
the JAX CLI's fixed step (``--step-jitter 0``) 48 steps come back to their
start in a near-Gaussian direction wherever L·ε is near a multiple of a
half period, and a chain that adapts to such ε stops moving in it: at
these defaults a quarter of the 4-chain runs then fail split R̂ < 1.1
(``benchmarks/torch_hmc_resonance.py``). ``--mesh-devices`` splits the chains over the ranks of a
``torch.distributed`` group this process belongs to (``shard.make_mesh``);
by default over all of its ranks when there is more than one.

Usage:
    python -m graphgp_tpu_torch.cli.hmc --graph-type grid --n-nodes 400 --kind diffusion
    python -m graphgp_tpu_torch.cli.hmc --device cpu --graph-type circle --n-nodes 60 \\
        --walks-per-node 100 --max-walk-length 3 --num-chains 2 --num-warmup 40 \\
        --num-samples 40 --num-leapfrog 6 --results-dir /tmp/r
"""
from __future__ import annotations

import argparse
from typing import Dict, List, NamedTuple

import numpy as np

from ..utils.config import add_config_flag, parse_with_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_flag(p)
    p.add_argument("--graph-type", default="grid")
    p.add_argument("--n-nodes", type=int, default=400)
    p.add_argument("--kind", default="diffusion", choices=["diffusion", "free"])
    p.add_argument("--walks-per-node", type=int, default=500)
    p.add_argument("--p-halt", type=float, default=0.1)
    p.add_argument("--max-walk-length", type=int, default=5)
    p.add_argument("--num-chains", type=int, default=4)
    p.add_argument(
        "--mesh-devices", type=int, default=0,
        help="shard chains over this many ranks of the process group (0 = all of "
             "them if >1)",
    )
    p.add_argument("--num-warmup", type=int, default=200)
    p.add_argument("--num-samples", type=int, default=300)
    p.add_argument("--num-leapfrog", type=int, default=48)
    p.add_argument("--initial-step-size", type=float, default=0.1)
    p.add_argument(
        "--step-jitter", type=float, default=0.1,
        help="jitter each iteration's leapfrog step uniformly within ±this fraction; "
             "0 is the JAX package's fixed step, whose chains stick at a resonant "
             "path length (gp.hmc.HMCConfig.step_jitter)",
    )
    p.add_argument("--prior-std", type=float, default=2.0)
    p.add_argument("--train-frac", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--results-dir", default="artifacts/results")
    return p


class Problem(NamedTuple):
    """The driver's problem up to its sampler (:func:`build_problem`)."""

    feats: object  # DenseFeatures
    tr: object  # train node ids (n_tr,), int64
    te: object  # test node ids
    y: object  # observed values on every node, float32
    fit: object  # exact.FitResult: the ML-II point estimate
    log_post: object  # one chain's log posterior over a parameter dict
    mode: Dict  # the log posterior's mode refined from fit.params
    refine_losses: object  # −logp at each L-BFGS step of the refine


def gp_log_posterior(feats, tr, y_tr, kind: str, prior_std: float, raw_noise_anchor: float):
    """The sampled posterior: the exact MLL, an iid N(0, prior_std²) prior on
    every raw parameter, and raw_noise anchored by N(raw_noise_anchor, 0.5²)."""
    from ..gp import exact, hmc

    # a weak noise anchor at the ML-II value removes the raw_noise → −∞
    # likelihood plateau that freezes chains (hmc.make_gp_log_posterior)
    return hmc.make_gp_log_posterior(
        lambda q: exact.mll(feats, q, tr, y_tr, kind=kind),
        prior_std=prior_std,
        anchors={"raw_noise": (raw_noise_anchor, 0.5)},
    )


def build_problem(args, dev) -> Problem:
    """The split (``default_rng(0)``), the step matrices from walk seed 42
    (on the card, the fused walk kernel K4), ML-II by 200 Adam steps, the log
    posterior anchored at the ML-II noise, and its mode polished by L-BFGS,
    as :func:`main` builds them from ``args`` (its parsed flags)."""
    import torch

    from ..data import synthetic
    from ..gp import exact, hmc
    from ..kernels import features_for_adjacency

    data = synthetic.generate(args.graph_type, args.n_nodes, seed=0)
    n = data["y_observed"].shape[0]
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    n_tr = int(n * args.train_frac)
    tr = torch.from_numpy(np.sort(perm[:n_tr]).astype(np.int64)).to(dev)
    te = torch.from_numpy(np.sort(perm[n_tr:]).astype(np.int64)).to(dev)
    y = torch.from_numpy(np.asarray(data["y_observed"], np.float32)).to(dev)

    # dense regime: on the card, the fused walk kernel (K4)
    feats = features_for_adjacency(
        data["adjacency"], 42, walks_per_node=args.walks_per_node, p_halt=args.p_halt,
        max_walk_length=args.max_walk_length, device=dev,
    )
    # ML-II point estimate as the chain init and the comparison
    fit = exact.fit(feats, tr, y[tr], kind=args.kind, num_steps=200,
                    generator=torch.Generator(device=dev).manual_seed(42))
    log_post = gp_log_posterior(feats, tr, y[tr], args.kind, args.prior_std,
                                float(fit.params["raw_noise"]))
    # polish the mode of the log posterior itself before the Laplace whitening
    mode, refine_losses = hmc.refine_mode(log_post, fit.params)
    return Problem(feats, tr, te, y, fit, log_post, mode, refine_losses)


def posterior_average(feats, samples: Dict, tr, y_tr, te, kind: str, num_samples: int):
    """The posterior-averaged predictive over samples thinned to about 32 a
    chain: every kept sample's exact posterior in one batched (vmapped)
    prediction. Returns (mixture mean, mixture variance, samples used), the
    first two as float32 numpy arrays over the test nodes."""
    import torch

    from ..gp import exact
    from ..gp import params as P

    thin = max(1, num_samples // 32)
    kept = {k: v[:, ::thin] for k, v in samples.items()}
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in kept.items()}  # chain-major

    def predict_one(params_one):
        post = exact.predict(feats, params_one, tr, y_tr, te, kind=kind)
        return post.mean, post.var + P.noise_variance(params_one)

    means, variances = torch.func.vmap(predict_one)(flat)
    means, variances = means.cpu().numpy(), variances.cpu().numpy()  # (S, n_te)
    return means.mean(0), variances.mean(0) + means.var(0), means.shape[0]


def main(argv=None) -> List[Dict]:
    args, _cfg = parse_with_config(build_parser(), argv)

    import torch
    import torch.distributed as dist

    from ..devices import resolve_device
    from ..gp import exact, hmc
    from ..modulators import softplus
    from ..utils.io import save_results

    dev = resolve_device(args.device)
    # HMC needs a low-noise energy: reduced-precision (TF32) matmuls jitter
    # the Cholesky MLL enough to reject trajectories at any step size, and
    # dual averaging then collapses ε. The dense problem is small, so full
    # float32 costs nothing that matters.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    feats, tr, te, y, fit, log_post, mode_params, refine_losses = build_problem(args, dev)
    point_post = exact.predict(feats, fit.params, tr, y[tr], te, kind=args.kind)
    point_rmse = float(exact.rmse(point_post, y[te]))
    point_nlpd = float(exact.nlpd(point_post, fit.params, y[te]))
    print(f"ML-II point estimate: rmse={point_rmse:.4f} nlpd={point_nlpd:.4f}")
    print(f"mode refine (L-BFGS on log posterior): -logp "
          f"{float(refine_losses[0]):.4f} -> {float(refine_losses[-1]):.4f}")
    mesh = None
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    mesh_devices = args.mesh_devices or (ranks if ranks > 1 else 0)
    if mesh_devices > 1:
        from ..shard import make_mesh

        mesh = make_mesh(mesh_devices, axis_name="chains")
        print(f"sharding {args.num_chains} chains over {mesh_devices} devices")

    res = hmc.sample_laplace(
        log_post, mode_params, torch.Generator().manual_seed(0),
        config=hmc.HMCConfig(
            num_warmup=args.num_warmup, num_samples=args.num_samples,
            num_leapfrog=args.num_leapfrog, initial_step_size=args.initial_step_size,
            step_jitter=args.step_jitter,
        ),
        num_chains=args.num_chains,
        mesh=mesh,
    )
    acc = res.accept_rate.cpu().numpy()
    print(f"accept rates: {acc.round(3)}  adapted step sizes: "
          f"{res.step_size.cpu().numpy().round(4)}")

    # split-chain R̂ on the log prob and on every parameter element
    rhat = float(hmc.split_rhat(res.log_probs))
    print(f"split-chain R-hat (log prob): {rhat:.3f}")
    param_rhats = {name: float(r.max()) for name, r in hmc.split_rhat_tree(res.samples).items()}
    for name, r in sorted(param_rhats.items()):
        print(f"split-chain R-hat ({name}): {r:.3f}")

    records: List[Dict] = [
        {"quantity": "point_rmse", "value": point_rmse},
        {"quantity": "point_nlpd", "value": point_nlpd},
        {"quantity": "rhat_logprob", "value": rhat},
    ]
    records += [{"quantity": f"rhat_{name}", "value": r} for name, r in param_rhats.items()]
    for c in range(args.num_chains):
        records.append({"quantity": f"accept_chain{c}", "value": float(acc[c])})

    mix_mean, mix_var, used = posterior_average(feats, res.samples, tr, y[tr], te, args.kind,
                                                args.num_samples)
    y_te = y[te].cpu().numpy()
    bayes_rmse = float(np.sqrt(np.mean((mix_mean - y_te) ** 2)))
    bayes_nlpd = float(
        np.mean(0.5 * (np.log(2 * np.pi * mix_var) + (y_te - mix_mean) ** 2 / mix_var))
    )
    print(f"posterior-averaged ({used} samples): rmse={bayes_rmse:.4f} nlpd={bayes_nlpd:.4f}")
    records += [
        {"quantity": "bayes_rmse", "value": bayes_rmse},
        {"quantity": "bayes_nlpd", "value": bayes_nlpd},
    ]

    if args.kind == "diffusion":
        betas = softplus(res.samples["raw_beta"]).cpu().numpy().ravel()
        print(f"beta posterior: {betas.mean():.3f} ± {betas.std():.3f}")
        records.append({"quantity": "beta_mean", "value": float(betas.mean())})
        records.append({"quantity": "beta_std", "value": float(betas.std())})

    if mesh is None or mesh.rank == 0:
        path = save_results(records, args.results_dir, "hmc", config=vars(args))
        print(f"results -> {path}")
    return records


if __name__ == "__main__":
    main()
