#!/usr/bin/env python3
"""Why an HMC chain sticks at the driver's defaults: fixed-path-length
resonance, tested directly, and the share of 4-chain runs that fail split
R-hat < 1.1 with and without a jittered step.

The problem is ``cli.hmc``'s at its defaults (``cli.hmc.build_problem``:
20x20 grid, 200 train, walks 500 from seed 42, L 5, diffusion, the ML-II
anchor, the refined mode), whitened as ``gp.hmc.sample_laplace`` whitens
it. Two parts, many chains in one batch (chains are independent: each has
its own draws, step size and mass):

1. Fixed step sweep. No warmup, unit mass, 48 leapfrog steps, each chain
   at its own step size from a grid (``HMCDraws.step_scale``). Leapfrog
   turns a unit-variance Gaussian direction by theta = 2 asin(eps/2) a
   step, so a trajectory of L steps comes back to its start where
   L·theta = 2πk, at eps_k = 2 sin(πk/L) (L 48: k 3, 4, 5, 6 at 0.3902,
   0.5176, 0.6428, 0.7654), and there the chain cannot move in that
   direction. Printed a step size: each whitened coordinate's within-chain
   standard deviation (about 1 where a chain mixes), and raw_noise's.
2. The driver's sampler (200 warmup with mass windows and dual averaging,
   300 samples) on CHAINS chains for each step jitter given: the chains in
   groups of 4 (a driver run each), the share of groups with a split R-hat
   >= 1.1 on the log prob or any parameter, and each stuck chain (raw_noise
   spread below half the median chain's) with its adapted step size.

Usage: python3 benchmarks/torch_hmc_resonance.py DEVICE CHAINS JITTER [JITTER ...]
    (DEVICE "cuda:0" or "cpu"; run from the repo's root)
"""
import math
import sys
import time

sys.path.insert(0, ".")
import numpy as np
import torch

import chip_smoke as cs
from graphgp_tpu_torch.cli import hmc as hmc_cli
from graphgp_tpu_torch.gp import hmc

SWEEP_EPS = np.round(np.arange(0.36, 0.80, 0.01), 2)
SWEEP_CHAINS = 8  # a step size
SWEEP_SAMPLES = 150
GROUP = 4  # chains a driver run
RHAT_MAX = 1.1


def main():
    dev, chains, jitters = sys.argv[1], int(sys.argv[2]), [float(j) for j in sys.argv[3:]]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = cs.card_line() if dev != "cpu" else "cpu"
    cs.log(card)
    args = hmc_cli.build_parser().parse_args([])
    prob = hmc_cli.build_problem(args, dev)
    flat0, sqrt_cov, spec = hmc.laplace_whitening(prob.log_post, prob.mode)
    dim = flat0.numel()
    noise_at = spec[0].index("raw_noise")

    def log_prob_z(zp):
        return prob.log_post(hmc._unflatten(flat0 + sqrt_cov @ zp["z"], spec))

    # 1. fixed step sweep
    L = args.num_leapfrog
    res_eps = [2 * math.sin(math.pi * k / L) for k in range(1, L // 2)]
    eps = np.repeat(SWEEP_EPS, SWEEP_CHAINS)
    c = eps.size
    draws = hmc.draw(c, SWEEP_SAMPLES, dim, torch.Generator().manual_seed(1))
    draws = draws._replace(step_scale=torch.from_numpy(eps.astype(np.float32))[:, None]
                           .expand(c, SWEEP_SAMPLES).contiguous())
    cfg = hmc.HMCConfig(num_warmup=0, num_samples=SWEEP_SAMPLES, num_leapfrog=L,
                        initial_step_size=1.0, adapt_mass=False)
    t0 = time.perf_counter()
    res = hmc.sample(log_prob_z, {"z": torch.zeros(dim, device=dev)}, config=cfg,
                     num_chains=c, draws=draws)
    z = res.samples["z"].cpu().numpy()  # (c, S, dim)
    noise = (flat0[noise_at].cpu().numpy()
             + np.einsum("j,csj->cs", sqrt_cov[noise_at].cpu().numpy(), z))
    z_sd = z.std(1).reshape(SWEEP_EPS.size, SWEEP_CHAINS, dim).mean(1)
    n_sd = noise.std(1).reshape(SWEEP_EPS.size, SWEEP_CHAINS).mean(1)
    acc = res.accept_rate.cpu().numpy().reshape(SWEEP_EPS.size, SWEEP_CHAINS).mean(1)
    cs.log(f"sweep: {c} chains x {SWEEP_SAMPLES} samples, {L} leapfrog steps, "
           f"{time.perf_counter() - t0:.1f} s; resonant eps_k = 2 sin(pi k/{L}): "
           + ", ".join(f"k {k} {e:.4f}" for k, e in enumerate(res_eps, 1) if 0.3 < e < 0.85))
    for i, e in enumerate(SWEEP_EPS):
        near = min(res_eps, key=lambda r: abs(r - e))
        cs.log(f"  eps {e:.2f} (nearest eps_k {near:.4f}): z sd "
               f"{[round(float(v), 3) for v in z_sd[i]]}, raw_noise sd {n_sd[i]:.4f}, "
               f"accept {acc[i]:.3f}")

    # 2. the driver's sampler, CHAINS chains a jitter
    for jitter in jitters:
        cfg = hmc.HMCConfig(num_warmup=args.num_warmup, num_samples=args.num_samples,
                            num_leapfrog=L, initial_step_size=args.initial_step_size,
                            step_jitter=jitter)
        t0 = time.perf_counter()
        res = hmc.sample_laplace(prob.log_post, prob.mode, torch.Generator().manual_seed(2),
                                 config=cfg, num_chains=chains)
        secs = time.perf_counter() - t0
        groups = chains // GROUP
        worst = []
        for g in range(groups):
            sl = slice(g * GROUP, (g + 1) * GROUP)
            r = [float(hmc.split_rhat(res.log_probs[sl]))]
            r += [float(v.max()) for v in hmc.split_rhat_tree(
                {k: v[sl] for k, v in res.samples.items()}).values()]
            worst.append(max(r))
        worst = np.asarray(worst)
        sd = res.samples["raw_noise"].std(1).cpu().numpy()
        steps = res.step_size.cpu().numpy()
        stuck = np.flatnonzero(sd < 0.5 * np.median(sd))
        fails = int((worst >= RHAT_MAX).sum())
        cs.log(f"jitter {jitter}: {chains} chains, {secs:.1f} s; {fails} of {groups} 4-chain "
               f"runs with split R-hat >= {RHAT_MAX} (worst {worst.max():.3f}); stuck chains "
               f"{stuck.size} (raw_noise sd < half the median {np.median(sd):.4f}), their eps "
               f"{[round(float(v), 4) for v in steps[stuck]]}; eps of all chains "
               f"{steps.min():.4f}-{steps.max():.4f}, accept "
               f"{res.accept_rate.min():.3f}-{res.accept_rate.max():.3f}")


if __name__ == "__main__":
    main()
