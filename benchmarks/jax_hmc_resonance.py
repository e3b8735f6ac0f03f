#!/usr/bin/env python3
"""The JAX package's sampler at fixed step sizes on the HMC driver's
whitened posterior, on the CPU: does a chain stop moving where the path
length is resonant, as the port's does (``benchmarks/torch_hmc_resonance.py``)?

The problem of ``graphgp_tpu.cli.hmc``'s defaults (as
``benchmarks/jax_hmc_keys.py`` builds it), then
``graphgp_tpu.gp.hmc.sample_laplace`` with no warmup, unit mass and 48
leapfrog steps at each step size given: a step size's chains, their
whitened coordinates' within-chain standard deviations (about 1 where a
chain mixes) and raw_noise's. A step size of 4 chains and 100 samples takes
about 15 minutes on a CPU of a few cores.

Usage: python3 benchmarks/jax_hmc_resonance.py SAMPLES EPS [EPS ...]   (run from the repo's root)
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

CHAINS = 4
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
flat0, spec = hmc._flatten(mode)
h = jax.hessian(lambda q: log_post(hmc._unflatten(q, spec)))(flat0)
evals, evecs = jnp.linalg.eigh(-0.5 * (h + h.T))
evals = jnp.maximum(evals, jnp.maximum(1e-4 * jnp.max(evals), 1e-10))
sqrt_cov = np.asarray(evecs * (1.0 / jnp.sqrt(evals))[None, :])
noise_at = sorted(mode).index("raw_noise")
samples = int(sys.argv[1])
for eps in map(float, sys.argv[2:]):
    t = time.time()
    cfg = hmc.HMCConfig(num_warmup=0, num_samples=samples, num_leapfrog=48,
                        initial_step_size=eps, adapt_mass=False)
    res = hmc.sample_laplace(log_post, mode, jax.random.PRNGKey(0), config=cfg, num_chains=CHAINS)
    q = np.concatenate([np.asarray(res.samples[k]).reshape(CHAINS, samples, -1)
                        for k in sorted(res.samples)], axis=-1)
    z = np.einsum("ij,csj->csi", np.linalg.pinv(sqrt_cov), q - np.asarray(flat0))
    z_sd = z.std(1).astype(np.float64).round(3).tolist()
    noise_sd = q[..., noise_at].std(1).astype(np.float64).round(4).tolist()
    accept = np.asarray(res.accept_rate, np.float64).round(3).tolist()
    print(f"eps {eps}: z sd a chain {z_sd}, raw_noise sd a chain {noise_sd}, accept {accept}, "
          f"{time.time() - t:.0f} s", flush=True)
