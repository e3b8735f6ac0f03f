#!/usr/bin/env python3
"""The JAX package's HMC at its driver's defaults for several PRNG keys, on
the CPU: split R-hat, each chain's raw_noise spread and step size a key.

The problem of ``graphgp_tpu.cli.hmc``'s defaults (20x20 grid, 200 train,
walks 500 from PRNGKey(42), L 5, diffusion; ML-II by 200 Adam steps, the
raw-noise anchor, the mode refined by L-BFGS), then
``graphgp_tpu.gp.hmc.sample_laplace`` (4 chains, 200 warmup + 300
samples, 48 leapfrog steps, eps0 0.1, float32 matmuls at "highest") for
each key given. The reference's own mixing rate at those defaults, beside
the port's (``benchmarks/torch_hmc_mixing.py``). A run takes over an hour
on a CPU of a few cores.

Usage: python3 benchmarks/jax_hmc_keys.py KEY [KEY ...]   (run from the repo's root)
"""
import sys
import time

sys.path.insert(0, ".")
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp
import numpy as np

from graphgp_tpu.data import synthetic
from graphgp_tpu.gp import exact, hmc
from graphgp_tpu.kernels import features_for_adjacency

data = synthetic.generate("grid", 400, seed=0)
perm = np.random.default_rng(0).permutation(400)
tr = jnp.asarray(np.sort(perm[:200]), jnp.int32)
y = jnp.asarray(data["y_observed"], jnp.float32)
feats = features_for_adjacency(data["adjacency"], jax.random.PRNGKey(42), walks_per_node=500,
                               p_halt=0.1, max_walk_length=5)
fit = exact.fit(feats, tr, y[tr], kind="diffusion", num_steps=200)
anchors = {"raw_noise": (float(fit.params["raw_noise"]), 0.5)}
log_post = hmc.make_gp_log_posterior(
    lambda q: exact.mll(feats, q, tr, y[tr], kind="diffusion"), prior_std=2.0, anchors=anchors)
mode, _ = hmc.refine_mode(log_post, fit.params)
cfg = hmc.HMCConfig(num_warmup=200, num_samples=300, num_leapfrog=48, initial_step_size=0.1)
for key in map(int, sys.argv[1:]):
    t = time.time()
    res = hmc.sample_laplace(log_post, mode, jax.random.PRNGKey(key), config=cfg, num_chains=4)
    r = {k: float(np.max(np.asarray(v))) for k, v in hmc.split_rhat_tree(res.samples).items()}
    r["logprob"] = float(hmc.split_rhat(res.log_probs))
    sd = np.asarray(res.samples["raw_noise"]).std(1).round(3)
    print("key", key, {k: round(v, 3) for k, v in r.items()}, "raw_noise chain sds", sd,
          "eps", np.asarray(res.step_size).round(3), f"{time.time() - t:.0f}s", flush=True)
