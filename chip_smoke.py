#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (graphgp_tpu_torch).

Drives the port's main paths on one CUDA card, the million-node GRF-Thompson
BO flagship, the scaling experiment with full-space prediction, the
dense-regime protocols (ablation and traffic regression, the latter also on
the PEMS-BAY dataset with the GCN baseline), the wind protocol, SVGP
classification, GRF-Thompson on the shipped facebook graph, the
orchestrator, Laplace-whitened HMC, the multi-device path, training over
features split across ranks and the isolated BO sweep, fails if any
record of any phase carries an error, and holds each hand-written kernel of
those paths against its plain PyTorch version on the paths' own tensors:

  1. prints the card's name and power limit, builds the kernels (one nvcc
     per source, in parallel) and prints ptxas's registers and spills of K1,
     dw, K2a and K2b at B = 1, 8, 16, of K3 (bulk and 4-byte copies) and of
     K4 (both load updates, and its table pack);
  2. small-input agreement: a 30x30 grid through the card's path and the
     plain CPU path, same draws, same answers; then full-space prediction on
     a 256-node ring and a 15x15 grid, card against CPU;
  3. the flagship: 1000x1000 grid, WalkConfig(1000, 0.1, 5),
     preprocess_graph(layout="auto"), then run_optimization with
     GRFThompson(kind="free") at batch 100 from 10 initial points; the kernel
     launch counters are zeroed just before and read just after; the fits
     and the draws' residual solves run on a train block, so no stencil
     product is differentiated there and K1 serves the draws' prior and
     correction;
  4. a profiled fit of PROFILE_EPOCHS epochs at the final observation set:
     wall and device time per epoch, the device's idle share, top kernels,
     and device ms per epoch of K1, its dw kernel, roll, elementwise ops and
     reductions;
  5. the scaling path through graphgp_tpu_torch.cli.scaling's phase functions
     at the reference protocol's top size (ring N = 2^20, walks_per_node 100,
     L = 3, train N/2, 50 Adam epochs, 64 pathwise samples) and at 256 and
     1024, where the dense sampler and the exact arm run too; counters zeroed
     just before and read just after; its full-space fits differentiate the
     stencil products, and every one must take its dw from K1's gradient
     kernel, with no shifted table built in a backward;
  6. the CG bench shape on the flagship's stencil (mask = every second node,
     B = 8, 20 iterations at tol 0): iterations/s through the fused K2 solve
     and through the K1 composition it replaces;
  7. K1 (stencil product, forward and transpose at B = 1, 8, 16), its dw
     kernel (B = 1, 16, bit-identical on repeat) and the autograd of both
     products, K2a and K2b (the fused masked-Gram passes, with their band
     plans; at B = 16 also with the offsets in dx-major order, K1 timed at
     each shape beside them) and K3 (ELL →
     stencil) against their plain versions, and their times (CUDA events)
     beside the plain version's, a library call's where one exists, and the
     bound from this run's shapes;
  8. the dense regime: the quickstart kernels, card against CPU and against
     the exact heat kernel; the ablation protocol through
     graphgp_tpu_torch.cli.ablation (30x30 mesh, beta 10, amplitude 10, noise
     0.5, p_halt 0.01, L 10, walks 1/10/100/1000, both load updates) and the
     traffic protocol through graphgp_tpu_torch.cli.regression (the PEMS
     sensor graph, N 321, 250 train, p_halt 0.1, L 10, walks 1..1024; then
     the same script's default grid, N 900), K4's counter zeroed just before each
     and read just after; then K4 (fused walks -> dense step matrices)
     against its plain version at those shapes and at the edge of its regime
     (N 4096, walks_per_node 8192, L 10), its kernels' device time (calls
     replayed from a CUDA graph, no host launch path) beside the wrapper's
     (CUDA events around calls from the host), and its bound from
     this run's walks, their integer work at the INT32 rate and their float
     work at the FP32 rate (after phase 10, also at the wind cell's sphere
     grid and the classification cell's community graph, both W 4096, L 5);
  9. GRF-Thompson on the shipped facebook graph (N 22470, skewed degrees:
     the walks take the CSR layout, the features ELL with its column-sorted
     transpose; no kernel of this package runs there): first, card against
     CPU on the real graph, the walks of the first 4096 start nodes at
     walks_per_node 16 (bit for bit), the transpose of their ELL built on
     the card (equal) and its two products (float32 order; each twice on
     the card, bit for bit); then graphgp_tpu_torch.cli.bo.main at the JAX
     CPU record's settings (20 iterations, walks_per_node 500, p_halt 0.1,
     L 5, batch 1, 10 initial points, 30 epochs, retrain every 10, cg_tol
     1e-2, gaussianized targets, BO seeds 100 and 110), caches in a
     temporary directory: the layout, R, the ELL's and the transpose's bytes,
     peak memory, preprocessing seconds by phase, fit and draw seconds and
     products per BO iteration, each seed's regret beside the record's
     1.4654 (finite, never rising, ending at or below its first), and the
     ELL forward and transposed products' ms at B = 1 and 16 (the fit's
     widths) beside their byte bounds, each twice bit for bit;
 10. K4 at this slice's shapes, its counter zeroed just before each path and
     read just after: the traffic CLI on the PEMS-BAY dataset through the
     loader (the JAX record's obs-noise 0.45, walks 1024, one seed) with the
     GCN baseline, beside the JAX record's seed 0; the wind protocol through
     graphgp_tpu_torch.cli.wind (synthetic 19x36 sphere grid, N 684, 290
     track nodes; walks 32, 512, 4096, free and diffusion, 300 Adam steps,
     200 pathwise samples): each fit's and prediction's seconds, RMSE and
     NLPD beside the JAX record's seed 0, 3 K4 launches, free RMSE at 4096
     below that at 32 and below 1; SVGP's posterior and ELBO card against
     CPU at the classification cell's shapes (rel 1e-4, TF32 off), then
     graphgp_tpu_torch.cli.classification on the synthetic community graph at
     Cora's shape (N 2485, 7 classes, 1988 train, 497 test, M 994, walks 4096,
     L 5, robustmax, Adam 3e-3 x 1000, two restarts), free (1 K4 launch) and
     exact_diffusion: fit seconds, accuracy (at least 0.5), NLL and ELBO
     beside the JAX records on real Cora;
 11. the orchestrator, graphgp_tpu_torch.cli.run_all over circle and grid at
     4096 nodes, random search and GRF-Thompson, 3 iterations: no error row,
     bo_all_graphs.csv written, K1 and K3 launched;
 12. Laplace-whitened HMC over the GP's hyperparameters:
     graphgp_tpu_torch.cli.hmc.main at the JAX driver's defaults (grid N
     400, walks 500, L 5, diffusion, 4 chains, 200 warmup + 300 samples, 48
     leapfrog steps), K4's counter zeroed just before and read just after
     (1 launch): seconds by stage (features, ML-II fit, refine, sampling,
     prediction), batched gradient evaluations a second, and the guards:
     every split R-hat below 1.1, every adapted step size above 0.01, every
     chain's accept rate above 0.2, finite posterior-averaged RMSE and NLPD,
     beta's spread above 0 (K4 at this shape is in phase 8's checks); then
     card against CPU on the driver's posterior built as the CLI builds it
     (on the CPU, the same step matrices on both): the log posterior and its
     gradient, its Hessian's clipped covariance, and HMC_CHECK_ITERS
     iterations of the sampler on the whitened target at the step sizes the
     driver adapted, under the same draws, every accept decision equal and
     those within HMC_MARGIN of their threshold reported;
 13. the multi-device path on the one card, an NCCL group of world size 1 at
     the multichip CLI's defaults (ring N 32768, walks 100, L 3): the sharded
     walk bit-identical to sample_walk_log, the distributed Gram CG on
     LogFeatures against the single-device CG (4096 train, B 8, 50
     iterations at tol 0, two all-reduces a matvec), then
     graphgp_tpu_torch.cli.multichip.main with --devices 1 (one spawned rank):
     walks/s and CG iterations/s, that card's throughput, not a scaling
     measurement;
 14. training and prediction with the features split over ranks, on an NCCL
     group of world size 1 at the same ring: gp.iterative.fit (every 8th
     node trains, 4096; diffusion; CG tol 1e-3, 50 iterations, 4 probes; 15
     Adam steps, the full-space solver) and pathwise_predict (4 samples at
     4096 held-out nodes) over shard.sharded_features, against the same
     calls on the whole features with the same probes and ε (losses,
     parameters, samples), seconds an Adam step, the collectives a Gram
     matvec (one all-reduce, one all-gather) and an Adam step; the ported
     shard.dryrun_multichip in the same group; then cli.bo --isolate, two
     cells (random search, GRF-Thompson) on a 1024-node grid with no error
     row, and one cell at a 5 s --cell-timeout, shorter than a child's
     start, which must be the one error row, naming the timeout.

Usage: python3 chip_smoke.py   (exits non-zero without a CUDA card)

Depth cut against the script's time limit: BO_ITERATIONS iterations of
TRAIN_EPOCHS Adam epochs (the reference protocol runs 50 x 30); DENSE_SEEDS
seed of the ablation and traffic protocols (they run 3), ABLATION_TRAIN_STEPS
optimizer steps per ablation fit (of 1000), and the default-grid traffic run at
the walks GRID_WALKS and GRID_TRAIN_STEPS L-BFGS steps (of 200); the traffic
protocol on the PEMS graph runs its full walks sweep at PEMS_TRAIN_STEPS
L-BFGS steps (of 200: cut so that the script, with the wind and
classification paths, stays near half its time limit). The
facebook cell runs uncut (FB_ITERATIONS iterations, both of FB_SEEDS). The
PEMS-BAY dataset run takes 1 seed of 3 and walks 1024 of the record's
1..8192; wind 1 seed of 3 at the CLI's 300 Adam steps (the JAX record ran
1000) and walks WIND_WALKS; classification 1 seed of 5; the orchestrator 1
run of 3 iterations at 4096 nodes; HMC and the multi-device path run uncut,
and so does the sharded fit (the JAX sharded training test's 15 steps).
Widths are the protocols' own.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
import warnings

GRID_SIDE = 1000
WALKS_PER_NODE = 1000
MAX_WALK_LENGTH = 5
P_HALT = 0.1
BATCH_SIZE = 100
INITIAL_POINTS = 10
BO_ITERATIONS = 10
TRAIN_EPOCHS = 30
PROFILE_EPOCHS = 3
BO_SEED = 100
DATA_SEED = 42

# H100 SXM published peaks: HBM bytes/s and
# fp32 (non-tensor-core) operations/s (NVIDIA's data sheet); int32
# operations/s: 64 INT32 lanes an SM (the Hopper architecture white paper,
# against 128 FP32 lanes) x 132 SMs x the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
REL_TOL_K1 = 1e-5  # relative to max |ref|: fp32 sums of 41 terms in another order (fma)
REL_TOL_K2 = 1e-5  # K2a/K2b: the same sums; the fused dot: N fp32 terms in another order

SCALING_SIZES = (256, 1024, 2**20)  # the reference protocol's small sizes and its top size
CG_BENCH_BATCH = 8
CG_BENCH_ITERS = 20

DENSE_SEEDS = 1              # the ablation and traffic protocols run 3 seeds
ABLATION_TRAIN_STEPS = 300   # the ablation protocol takes 1000 optimizer steps per fit
GRID_WALKS = (1, 1024)       # the default-grid traffic run (the protocol sweeps 1, 4, ..., 1024)
GRID_TRAIN_STEPS = 50        # ... at 200 L-BFGS steps per fit
PEMS_TRAIN_STEPS = 100       # the PEMS sweep's L-BFGS steps per fit (the protocol takes 200)
PEMS_NPZ = "processed_data/pems_bay.npz"
# K4 against its plain version, relative to max |ref|: the walks are
# bit-identical; each cell is a float32 sum of up to W loads. The kernel sums
# (float atomics into the output, in no fixed order) and divides by W once; the plain
# version adds W copies of fl(load / W) one after another, which leaves it up
# to W * 2^-24 of the largest cell from the true sum in the worst case (6e-5
# at W = 1000; 9.3e-6 was read at the ablation protocol's ad-hoc shape).
REL_TOL_K4 = 3e-5
# a kernel's time replayed from a CUDA graph against its wrapper's, read one
# after the other
ALONE_SLACK = 0.1
# the transplant arm on the PEMS graph is Monte-Carlo-noise-limited (mean
# degree 12: the per-step importance factors are large); the JAX package's
# recorded runs on this graph read 11-19 times the pofm_diffusion RMSE at
# walks_per_node 1024
TRANSPLANT_MARGIN = 50.0
# The work K4's walks need, whatever kernel does it. A tried transition draws
# one uniform (the halt test), a taken one a second (the pick). A uniform is
# one splitmix32 mix of the per-block prefix and the walk index: an xor, the
# mix's 2 multiplies, 3 shifts and 3 xors, and the shift that keeps 24 bits,
# 10 integer operations; then a conversion and a scaling, 2 float ones. The
# halt test is 1 float compare a tried transition. A taken transition clamps
# its pick (2 integer operations) and converts the degree, multiplies, and
# truncates (3 float ones), updates the load (3 float multiplies, none under
# ablation) and adds its record at the next step (1 float add). Each output
# element is divided by W once. The integer and the float pipes run side by
# side, so the operations' time is the larger of the two.
K4_INT_OPS_PER_UNIFORM = 10
K4_INT_OPS_TAKEN = 2
K4_FP_OPS_PER_UNIFORM = 2
K4_FP_OPS_TRIED = 1
K4_FP_OPS_TAKEN = 7
K4_FP_OPS_TAKEN_ABLATION = 4

# The facebook BO cell (the JAX package's only BO run on a real graph, the CPU
# record artifacts/results/bo_facebook_cpu/): its seeds, its final regret,
# and the card-against-CPU check's start nodes and walks
FB_ITERATIONS = 20
FB_SEEDS = (100, 110)
FB_REGRET_JAX_CPU = 1.4654
FB_CHECK_NODES = 4096
FB_CHECK_WPN = 16
FB_PROBES = 16  # the fit's batch width: the SLQ probes
# the ELL products, card against CPU, relative to max |ref|: float32 sums of
# up to R (or 128, then a column's virtual rows) terms in another order
REL_TOL_FB = 1e-5


# This slice's cells: the wind protocol on its synthetic sphere grid (the
# JAX record ran 1000 Adam steps, walks 32..8192), classification on the
# synthetic community graph at Cora's shape (the JAX records are real Cora's,
# free and exact-diffusion), the traffic CLI on the PEMS-BAY dataset with
# the GCN baseline (the JAX record's settings), and the orchestrator.
WIND_WALKS = (32, 512, 4096)
WIND_RECORD = "artifacts/results/wind.csv"
CLASS_NODES, CLASS_CLASSES, CLASS_TRAIN = 2485, 7, 1988
CLASS_ARGV = ["--n-nodes", str(CLASS_NODES), "--num-classes", str(CLASS_CLASSES),
              "--walks-per-node", "4096", "--max-walk-length", "5", "--p-halt", "0.1",
              "--likelihood", "robustmax", "--learning-rate", "3e-3", "--num-steps", "1000",
              "--seeds", "1"]
CLASS_RECORDS = ("artifacts/results/classification.csv",
                 "artifacts/results/cora_exact/classification.csv")
# the SVGP posterior and ELBO, card against CPU, relative to max |ref|:
# float32 Cholesky (M = 994) and triangular solves from two libraries
REL_TOL_SVGP = 1e-4
PEMS_BAY_RECORD = "artifacts/results/pems_bay/regression.csv"
PEMS_BAY_OBS_NOISE = 0.45
PEMS_BAY_WALKS = 1024
RUN_ALL_ARGV = ["--graph-types", "circle", "grid", "--n-nodes", "4096", "--runs", "1",
                "--iterations", "3", "--algorithms", "random_search", "grf_thompson"]

# This slice's cells: Laplace-whitened HMC at the JAX driver's defaults (grid
# N 400, walks 500, p_halt 0.1, L 5, diffusion, 4 chains, 200 warmup + 300
# samples, 48 leapfrog steps), and the multi-device path on one card at the
# multichip CLI's defaults (ring N 32768, walks 100, L 3, 4096 train, B 8,
# 50 CG iterations).
HMC_ARGV = []  # cli.hmc's defaults
HMC_CHAINS = 4
HMC_CHECK_ITERS = 20  # card against CPU: iterations of the sampler under the same draws
# card against CPU, relative to max |ref|: the log posterior, its gradient
# and the sampler's trajectory go through a float32 Cholesky of 200 rows in
# two libraries (cuSOLVER, LAPACK); the Hessian through forward-over-reverse
# derivatives of it
REL_TOL_HMC = 1e-4
REL_TOL_HMC_HESSIAN = 1e-3
REL_TOL_HMC_TRAJECTORY = 1e-3
HMC_MARGIN = 1e-3  # nats: accept decisions this close to their threshold are reported
HMC_RHAT_MAX = 1.1
HMC_STEP_MIN = 0.01
HMC_ACCEPT_MIN = 0.2
MULTI_N, MULTI_WPN, MULTI_L = 32768, 100, 3
MULTI_TRAIN, MULTI_BATCH, MULTI_CG_ITERS = 4096, 8, 50
# the distributed CG against the single-device CG, 50 iterations at tol 0:
# float32 sums in another order (the transposed product adds by atomics)
REL_TOL_MULTI_CG = 1e-4
# Phase 14, training and prediction with the features split over ranks, at
# the multichip CLI's ring: every 8th node trains (4096), the JAX sharded
# training test's solver (CG tol 1e-3, 50 iterations, 4 probes) for 15 Adam
# steps, then 4 pathwise samples at 4096 held-out nodes. Sharded (an NCCL
# group of one) against unsharded on the card, same probes and ε: CG stops
# at tol 1e-3 in float32 sums of another order (the walk log's transposed
# product adds by atomics), which Adam's normalised steps carry on.
SHARD_STRIDE, SHARD_STEPS, SHARD_SAMPLES = 8, 15, 4
SHARD_SETTINGS = dict(cg_tol=1e-3, cg_max_iters=50, num_probes=4)
REL_TOL_SHARD_LOSS = 1e-3
ABS_TOL_SHARD_PARAMS = 1e-2
REL_TOL_SHARD_SAMPLES = 1e-3
# the isolated BO sweep: two cells on a small grid, then one cell whose
# timeout is shorter than a child's start on the card
ISOLATE_ARGV = ["--graph-type", "grid", "--n-nodes", "1024", "--iterations", "3",
                "--initial-points", "5", "--walks-per-node", "100", "--max-walk-length", "3",
                "--train-epochs", "3", "--bo-seeds", "100", "--isolate"]
ISOLATE_SHORT_TIMEOUT = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def ptxas_by_kernel(build_log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v output."""
    out: dict = {}
    name, spill = None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, int_ops: float = 0.0) -> tuple:
    """The least time for the work: the bytes at the HBM rate, or the float
    operations at the FP32 rate, or the integer ones at the INT32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, reps: int = 10, replays: int = 3) -> float:
    """Device milliseconds per call of ``fn`` without the host's launch path:
    ``reps`` calls captured in one CUDA graph, replayed ``replays`` times
    after a warm-up replay, each replay between CUDA events; the fastest
    replay counts. The kernels' gaps inside the graph count, so this reads
    at or above the kernels' own durations."""
    import torch

    fn()  # a wrapper's first call sets its kernels' attributes, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    reads = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        reads.append(start.elapsed_time(end) / reps)
    del graph
    return min(reads)


def check_alone(label: str, alone: float, wrapper: float) -> None:
    """The calls replayed from a CUDA graph take no longer than the same calls
    launched from the host (CUDA events around back-to-back calls), within
    ALONE_SLACK: the two are read in separate runs."""
    check(alone <= wrapper * (1.0 + ALONE_SLACK),
          f"{label}: kernel alone {alone:.4f} ms above the wrapper's {wrapper:.4f} ms")


def rel_err(out, ref) -> tuple:
    err = float((out - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 2: small-input agreement, card path vs plain CPU path
# ---------------------------------------------------------------------------


def small_agreement(device) -> None:
    import numpy as np
    import torch

    from graphgp_tpu_torch.data import synthetic
    from graphgp_tpu_torch.gp import iterative
    from graphgp_tpu_torch.preprocessor import preprocess_graph
    from graphgp_tpu_torch.walker import WalkConfig

    data = synthetic.generate("grid", 900, seed=0)
    cfg = WalkConfig(walks_per_node=200, p_halt=0.1, max_walk_length=5)
    feats = {d: preprocess_graph(data["adjacency"], cfg, layout="auto", device=d)
             for d in ("cpu", device)}
    np.testing.assert_array_equal(feats["cpu"].mats.offsets, feats[device].mats.offsets)
    torch.testing.assert_close(feats[device].mats.vals.cpu(), feats["cpu"].mats.vals,
                               rtol=0, atol=1e-6)
    rng = np.random.default_rng(1)
    n_obs, cap = 40, 64
    idx = np.zeros(cap, np.int64)
    idx[:n_obs] = rng.choice(900, n_obs, replace=False)
    y = np.zeros(cap, np.float32)
    y[:n_obs] = data["y_observed"][idx[:n_obs]]
    mask = (np.arange(cap) < n_obs).astype(np.float32)
    probes = (rng.integers(0, 2, (16, cap)) * 2 - 1).astype(np.float32)
    eps1 = rng.standard_normal((4, 900)).astype(np.float32)
    eps2 = rng.standard_normal((4, cap)).astype(np.float32)
    modulator = rng.standard_normal(5).astype(np.float32)
    settings = iterative.CGSettings(cg_tol=1e-6, cg_max_iters=200)
    results = {}
    for d in ("cpu", device):
        t = lambda a: torch.from_numpy(a).to(d)
        params = {"raw_noise": torch.tensor(-2.0, device=d),
                  "modulator": t(modulator).requires_grad_(True)}
        mll = iterative.mll_cg(feats[d], params, t(idx), t(y), settings=settings,
                               mask=t(mask), num_real=float(n_obs), probes=t(probes))
        mll.backward()
        sample = iterative.pathwise_predict(
            feats[d], params, t(idx), t(y), torch.arange(900, device=d), num_samples=4,
            settings=settings, mask=t(mask), eps1=t(eps1), eps2=t(eps2))
        results[d] = (mll.detach().cpu(), params["modulator"].grad.cpu(), sample.cpu())
    for name, a, b in zip(("mll", "d mll/d f", "pathwise"), results[device], results["cpu"]):
        err, rel = rel_err(a, b)
        log(f"small-input agreement {name}: max abs err {err:.3e} (rel {rel:.3e})")
        check(rel <= 1e-4, f"small-input {name} disagrees: rel {rel}")


def small_agreement_full_space(device) -> None:
    """pathwise_predict(full_space=True): the card (K1 and K2) against the
    plain CPU path on one stencil, same draws. The ring at L = 3 has offsets
    in ±2, all wrapping; the 15x15 grid leaves a tail in K2's last block."""
    import numpy as np
    import torch

    from graphgp_tpu_torch.data import synthetic
    from graphgp_tpu_torch.gp import iterative
    from graphgp_tpu_torch.preprocessor import preprocess_graph
    from graphgp_tpu_torch.walker import WalkConfig

    settings = iterative.CGSettings(cg_tol=1e-6, cg_max_iters=300)
    for graph_type, n in (("ring", 256), ("grid", 225)):
        data = synthetic.generate(graph_type, n, seed=0)
        cfg = WalkConfig(walks_per_node=100, p_halt=0.1, max_walk_length=3)
        feats_cpu = preprocess_graph(data["adjacency"], cfg, layout="auto", device="cpu")
        rng = np.random.default_rng(2)
        perm = rng.permutation(n)
        tr, te = np.sort(perm[: n // 2]), np.sort(perm[n // 2:])
        eps1 = rng.standard_normal((20, n)).astype(np.float32)  # 20 samples: two K2 chunks
        eps2 = rng.standard_normal((20, tr.size)).astype(np.float32)
        modulator = np.asarray([1.0, 0.5, 0.25], np.float32)
        out = {}
        for d in ("cpu", device):
            t = lambda a: torch.from_numpy(a).to(d)
            params = {"raw_noise": torch.tensor(-2.0, device=d), "modulator": t(modulator)}
            out[d] = iterative.pathwise_predict(
                feats_cpu.to(d), params, t(tr), t(data["y_observed"][tr]), t(te),
                num_samples=20, settings=settings, full_space=True, eps1=t(eps1), eps2=t(eps2),
            ).cpu()
        err, rel = rel_err(out[device], out["cpu"])
        log(f"small-input agreement full-space pathwise, {graph_type} {n}: "
            f"max abs err {err:.3e} (rel {rel:.3e})")
        check(rel <= 1e-4, f"small-input full-space {graph_type} disagrees: rel {rel}")


# ---------------------------------------------------------------------------
# Phase 3: the flagship main path
# ---------------------------------------------------------------------------


def _guard_k1_backward(k1):
    """Wrap K1's backward for one run: count the products differentiated on
    the card and the dw launches they need, and any shifted table built or
    plain dw reduction run on the card inside a backward. Returns (stats,
    restore)."""
    stats = {"products": 0, "dw_needed": 0, "tables_in_backward": 0, "plain_dw_on_card": 0}
    real = (k1._StencilMatvec.backward, k1.shifted_weights, k1._dw_matvec)
    depth = [0]

    def backward(ctx, g):
        if ctx.needs_input_grad[0] and g.is_cuda:
            stats["products"] += 1
            stats["dw_needed"] += -(-g.shape[0] // k1.MAX_BATCH)
        depth[0] += 1
        try:
            return real[0](ctx, g)
        finally:
            depth[0] -= 1

    def shifted_weights(w, offsets):
        stats["tables_in_backward"] += depth[0] > 0
        return real[1](w, offsets)

    def dw_plain(v, g, offsets):
        stats["plain_dw_on_card"] += v.is_cuda
        return real[2](v, g, offsets)

    k1._StencilMatvec.backward = staticmethod(backward)
    k1.shifted_weights, k1._dw_matvec = shifted_weights, dw_plain

    def restore():
        k1._StencilMatvec.backward = staticmethod(real[0])
        k1.shifted_weights, k1._dw_matvec = real[1], real[2]

    return stats, restore


def flagship(device) -> dict:
    import numpy as np
    import torch

    from graphgp_tpu_torch.bo import GRFThompson, run_optimization
    from graphgp_tpu_torch.cuda_kernels import stencil as k1
    from graphgp_tpu_torch.cuda_kernels import stencil_build as k3
    from graphgp_tpu_torch.data import synthetic
    from graphgp_tpu_torch.gp import iterative
    from graphgp_tpu_torch.preprocessor import preprocess_graph
    from graphgp_tpu_torch.walker import WalkConfig

    n = GRID_SIDE * GRID_SIDE
    t0 = time.perf_counter()
    data = synthetic.generate("grid", n, seed=DATA_SEED)
    log(f"data: {n} nodes, {data['adjacency'].nnz} edges, {time.perf_counter() - t0:.2f} s")
    cfg = WalkConfig(walks_per_node=WALKS_PER_NODE, p_halt=P_HALT, max_walk_length=MAX_WALK_LENGTH)
    log(f"depth cut: {BO_ITERATIONS} BO iterations x {TRAIN_EPOCHS} Adam epochs "
        "(reference protocol: 50 x 30); widths uncut")

    k1.launches = k1.dw_launches = 0
    k3.launches = 0
    guard, restore_k1 = _guard_k1_backward(k1)
    trace: dict = {}
    torch.cuda.reset_peak_memory_stats()
    feats = preprocess_graph(data["adjacency"], cfg, seed=DATA_SEED, cache_dir=None,
                             layout="auto", device=device, trace=trace)
    algo = GRFThompson(
        feats, n, np.random.default_rng(BO_SEED), kind="free", learning_rate=0.1,
        train_epochs=TRAIN_EPOCHS, retrain_interval=10,
        settings=iterative.CGSettings(cg_tol=1e-2, cg_max_iters=100),
        observation_capacity=INITIAL_POINTS + BO_ITERATIONS * BATCH_SIZE, device=device,
    )
    per_iteration = []
    select = algo.select_next_points

    def counted_select(*args, **kwargs):
        before = k1.launches
        picked = select(*args, **kwargs)
        per_iteration.append(k1.launches - before)
        return picked

    algo.select_next_points = counted_select
    t_bo = time.perf_counter()
    result = run_optimization(algo, data["y_observed"], n_iterations=BO_ITERATIONS,
                              initial_points=INITIAL_POINTS, batch_size=BATCH_SIZE, seed=BO_SEED)
    torch.cuda.synchronize()
    bo_s = time.perf_counter() - t_bo
    restore_k1()
    launches = {"stencil_matvec": k1.launches, "stencil_dw": k1.dw_launches,
                "ell_to_stencil": k3.launches}

    mats = trace["ell"]
    s_count = feats.mats.num_offsets
    log(f"walk+consolidate: {trace['walk_consolidate_s']:.2f} s  (L={mats.max_walk_length}, "
        f"R={mats.row_capacity})")
    log(f"vocabulary+K3: {trace['stencil_build_s']:.2f} s  (S={s_count})")
    for i, (fit_s, draw_s) in enumerate(zip(algo.phase_seconds["fit"], algo.phase_seconds["draw"])):
        log(f"BO iteration {i + 1}: fit {fit_s:.2f} s ({TRAIN_EPOCHS} epochs), "
            f"Thompson draw {draw_s:.2f} s")
    log(f"BO total: {bo_s:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    regrets = result.regrets()
    log(f"regret per iteration: {regrets.tolist()}  final {regrets[-1]:.4f}")
    log(f"launches on the main path: {launches}; K1 launches per BO iteration (the draws' "
        f"prior, solve and correction; the fits solve on the train block): {per_iteration}")
    log(f"K1 backward on the main path: {guard['products']} products differentiated on the card, "
        f"{launches['stencil_dw']} dw launches")

    check(launches["stencil_matvec"] > 0, "K1 was not launched on the main path")
    check(guard["products"] == 0 and launches["stencil_dw"] == 0,
          "a fit on the main path differentiated a stencil product: its train block was not used")
    check(launches["ell_to_stencil"] > 0, "K3 was not launched on the main path")
    check(feats.mats.vals.shape == (MAX_WALK_LENGTH, s_count, n), "stencil shape")
    check(bool(torch.isfinite(feats.mats.vals).all()), "stencil values not finite")
    check(bool(np.isfinite(regrets).all()), "regret not finite")
    check(bool(np.all(np.diff(regrets) <= 0)), "regret increased")
    picked = result.observed_idx
    check(picked.size == INITIAL_POINTS + BO_ITERATIONS * BATCH_SIZE, "observation count")
    check(np.unique(picked).size == picked.size, "a node was picked twice")
    check(bool(((picked >= 0) & (picked < n)).all()), "picked node out of range")
    for v in algo.cached_params.values():
        check(bool(torch.isfinite(v).all()), "fitted parameters not finite")
    return {"feats": feats, "mats": mats, "algo": algo, "result": result, "launches": launches,
            "params": algo.cached_params}


# ---------------------------------------------------------------------------
# Phase 4: where a fit's time goes
# ---------------------------------------------------------------------------


def device_events(fn) -> list:
    """The device activity (kernels and copies) torch.profiler records while
    ``fn()`` runs to its end; op rows, which repeat their kernels' time, are
    left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def fit_profile(device, flag: dict) -> None:
    import torch

    from graphgp_tpu_torch.gp import iterative

    algo, result = flag["algo"], flag["result"]
    idx, y, mask = algo._padded_observations(result.observed_idx, result.observed_y)
    args = dict(kind="free", init=algo.cached_params, learning_rate=0.1,
                settings=algo.settings, mask=torch.from_numpy(mask).to(device),
                num_real=float(result.observed_idx.size), generator=algo.generator)
    train_idx, y_t = torch.from_numpy(idx).to(device), torch.from_numpy(y).to(device)
    iterative.fit(flag["feats"], train_idx, y_t, num_steps=1, **args)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iterative.fit(flag["feats"], train_idx, y_t, num_steps=PROFILE_EPOCHS, **args)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_EPOCHS
    dev_events = device_events(
        lambda: iterative.fit(flag["feats"], train_idx, y_t, num_steps=PROFILE_EPOCHS, **args))
    dev_ms = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3 / PROFILE_EPOCHS
    by_name: dict = {}
    for e in dev_events:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    log(f"fit profile ({result.observed_idx.size} observations, capacity {idx.size}): "
        f"wall {wall_ms:.2f} ms/epoch unprofiled")
    if dev_ms <= 0:
        log("fit profile: the profiler saw no device time; device share not measured")
        return
    log(f"fit profile: device kernels {dev_ms:.2f} ms/epoch, idle share "
        f"{max(0.0, 1 - dev_ms / wall_ms):.3f} of the unprofiled wall time")
    for name, (t_us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {t_us / 1e3 / PROFILE_EPOCHS:8.3f} ms/epoch {count // PROFILE_EPOCHS:6d} "
            f"calls/epoch  {name[:90]}")
    groups: dict = {}
    for name, (t_us, count) in by_name.items():
        t, c = groups.get(_op_group(name), (0.0, 0))
        groups[_op_group(name)] = (t + t_us, c + count)
    log("fit profile by op, per epoch: " + "; ".join(
        f"{g} {groups.get(g, (0.0, 0))[0] / 1e3 / PROFILE_EPOCHS:.3f} ms "
        f"({groups.get(g, (0.0, 0))[1] // PROFILE_EPOCHS} calls)" for g in OP_GROUPS))


OP_GROUPS = ("K1", "K1 dw", "roll", "elementwise", "reductions", "other")


def _op_group(kernel_name: str) -> str:
    """The fit profile's op group of one device kernel's name."""
    if "stencil_matvec_kernel" in kernel_name:
        return "K1"
    if "stencil_dw_kernel" in kernel_name:
        return "K1 dw"
    if "roll" in kernel_name:
        return "roll"
    if "elementwise" in kernel_name:
        return "elementwise"
    if "reduce" in kernel_name:
        return "reductions"
    return "other"


# ---------------------------------------------------------------------------
# Phase 5: the scaling path (full-space prediction through K2)
# ---------------------------------------------------------------------------


def scaling_path(device) -> dict:
    import numpy as np
    import torch

    from graphgp_tpu_torch.cli import scaling
    from graphgp_tpu_torch.cuda_kernels import gram as k2
    from graphgp_tpu_torch.cuda_kernels import stencil as k1
    from graphgp_tpu_torch.cuda_kernels import stencil_build as k3
    from graphgp_tpu_torch.data.synthetic import generate_ring_data

    # the protocol's defaults: walks_per_node 100, p_halt 0.1, L 3, 50 Adam
    # epochs at lr 0.1, cg_tol 1e-2, 64 pathwise samples
    args = scaling.build_parser().parse_args(
        ["--sizes", *map(str, SCALING_SIZES), "--device", device])
    args.cache_dir = None  # walk every time: no step-matrix cache on disk
    log(f"scaling path: ring sizes {SCALING_SIZES}, walks_per_node {args.walks_per_node}, "
        f"L {args.max_walk_length}, {args.train_epochs} epochs, "
        f"{args.num_pathwise_samples} pathwise samples, cg_tol {args.cg_tol}; nothing cut")

    # record what each fused solve was given and how many iterations it took
    solves = []
    last_call = {}
    fused_solve = k2.gram_cg

    def recording_solve(phi, noise_var, mask, b_rhs, **kwargs):
        res = fused_solve(phi, noise_var, mask, b_rhs, **kwargs)
        solves.append((b_rhs.shape[1], b_rhs.shape[0], res.iterations))
        last_call.update(phi=phi, noise_var=noise_var, mask=mask, b_rhs=b_rhs)
        return res

    k1.launches = k1.dw_launches = k3.launches = 0
    k2.rmv_mask_launches = k2.mv_epilogue_launches = 0
    records: list = []
    k2.gram_cg = recording_solve
    guard, restore_k1 = _guard_k1_backward(k1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scaling.run_rw_phase(list(SCALING_SIZES), args, records)
    scaling.run_gp_phase(list(SCALING_SIZES), args, records, exact_mode=False)
    scaling.run_gp_phase([n for n in SCALING_SIZES if n <= args.exact_max], args, records,
                         exact_mode=True)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    k2.gram_cg = fused_solve
    restore_k1()
    check_no_error_rows("scaling", records)
    launches = {"stencil_matvec": k1.launches, "stencil_dw": k1.dw_launches,
                "ell_to_stencil": k3.launches, "gram_rmv_mask": k2.rmv_mask_launches,
                "gram_mv_epilogue": k2.mv_epilogue_launches}

    by = {(r["phase"], r["n_nodes"]): r for r in records}
    for n in SCALING_SIZES:
        rw, it = by[("rw", n)], by[("iterative_gp", n)]
        iters = [i for (nn, _, i) in solves if nn == n]
        steady = iters[len(iters) // 2:]  # each size predicts twice; the second is the timed one
        line = (f"scaling n={n}: walk+consolidate {rw['rw_seconds']:.3f} s "
                f"({rw['walks_per_s']:,.0f} walks/s), train {it['train_seconds']:.2f} s, "
                f"predict {it['predict_seconds']:.3f} s, rmse {it['rmse']:.4f}, "
                f"CG iterations of the predict solve per 16-row chunk {steady}")
        if ("exact_gp", n) in by:
            ex = by[("exact_gp", n)]
            line += (f"; exact arm: train {ex['train_seconds']:.2f} s, predict "
                     f"{ex['predict_seconds']:.3f} s, rmse {ex['rmse']:.4f}")
        if "dense_rw_seconds" in rw:
            line += f"; dense sampler {rw['dense_rw_seconds']:.3f} s"
        log(line)
    log(f"scaling path total: {total_s:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches on the scaling path: {launches}")
    log(f"K1 backward on the scaling path (full-space fits): {guard['products']} products "
        f"differentiated on the card, {guard['dw_needed']} dw launches needed, "
        f"{launches['stencil_dw']} made; shifted tables built in a backward "
        f"{guard['tables_in_backward']}, plain dw reductions on the card "
        f"{guard['plain_dw_on_card']}")

    check(launches["stencil_dw"] > 0, "K1's dw kernel was not launched on the scaling path")
    check(guard["products"] > 0 and launches["stencil_dw"] == guard["dw_needed"],
          "a stencil product differentiated on the card did not go through the dw kernel")
    check(guard["tables_in_backward"] == 0 and guard["plain_dw_on_card"] == 0,
          "a backward built a shifted table or ran the plain dw reduction on the card")
    check(launches["gram_rmv_mask"] > 0, "K2a was not launched on the scaling path")
    check(launches["gram_rmv_mask"] == launches["gram_mv_epilogue"],
          "K2a and K2b launch counts differ")
    check(launches["stencil_matvec"] > 0, "K1 was not launched on the scaling path")
    check(launches["ell_to_stencil"] > 0, "K3 was not launched on the scaling path")
    check(launches["gram_rmv_mask"] == sum(i for (_, _, i) in solves),
          "K2 launches do not add up to the fused solves' iterations")
    for n in SCALING_SIZES:
        y_std = float(generate_ring_data(n, seed=args.seed)["y_observed"].std())
        phases = ["iterative_gp"] + (["exact_gp"] if n <= args.exact_max else [])
        for phase in phases:
            check((phase, n) in by, f"{phase} did not run at n={n}")
            rmse = by[(phase, n)]["rmse"]
            check(np.isfinite(rmse) and rmse < y_std,
                  f"{phase} n={n}: rmse {rmse} is not below the targets' std {y_std}")
        check(np.isfinite(by[("rw", n)]["walks_per_s"]), "walk rate not finite")
    check(last_call["b_rhs"].shape[1] == SCALING_SIZES[-1], "last fused solve is not the top size")
    return {"launches": launches, "last_call": last_call, "records": records}


# ---------------------------------------------------------------------------
# Phase 6: the CG bench shape on the flagship's stencil
# ---------------------------------------------------------------------------


def device_busy_ms(fn) -> float:
    """Milliseconds of device activity (kernels and copies) inside ``fn()``;
    0.0 if the profiler saw no device events."""
    return sum(e.time_range.elapsed_us() for e in device_events(fn)) / 1e3


def cg_bench(device, flag: dict) -> dict:
    """Grid N = 1e6, S = 41, n_train = N/2, B = 8, 20 CG iterations at tol 0:
    the fused solve (one K2a and one K2b per iteration) beside the composition
    it replaces (two K1 launches plus elementwise passes per iteration)."""
    import torch

    from graphgp_tpu_torch.cuda_kernels import gram as k2
    from graphgp_tpu_torch.features import contract
    from graphgp_tpu_torch.gp import iterative
    from graphgp_tpu_torch.gp import params as P
    from graphgp_tpu_torch.linalg import batched_cg

    feats, params = flag["feats"], flag["params"]
    n = feats.num_nodes
    with torch.no_grad():
        phi = contract(feats, params["modulator"])
        noise_var = P.noise_variance(params)
    mask = torch.zeros(n, device=device)
    mask[::2] = 1.0
    gen = torch.Generator(device=device).manual_seed(1)
    b = torch.randn((CG_BENCH_BATCH, n), generator=gen, device=device) * mask[None, :]
    matvec = iterative.make_gram_matvec_bm_full()

    def fused():
        return k2.gram_cg(phi, noise_var, mask, b, tol=0.0, max_iters=CG_BENCH_ITERS)

    def composed():
        with torch.no_grad():
            return batched_cg(matvec, (phi, noise_var, mask), b, tol=0.0,
                              max_iters=CG_BENCH_ITERS)

    def seconds(fn):
        fn()  # warm
        torch.cuda.synchronize()
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    # in turns, so both see the same card state
    times = {"fused": [], "composed": []}
    for name, fn in (("composed", composed), ("fused", fused), ("fused", fused),
                     ("composed", composed)):
        times[name].append(seconds(fn))
    res_f, res_c = fused(), composed()
    check(res_f.iterations == res_c.iterations == CG_BENCH_ITERS, "CG bench iteration count")
    err, rel = rel_err(res_f.x, res_c.x)
    check(rel <= 1e-3, f"fused CG and the K1 composition disagree: rel {rel}")
    s_f, s_c = min(times["fused"]), min(times["composed"])
    busy = device_busy_ms(fused)
    out = {"fused_iters_per_s": CG_BENCH_ITERS / s_f, "composed_iters_per_s": CG_BENCH_ITERS / s_c}
    log(f"CG bench N={n} S={feats.mats.num_offsets} n_train={n // 2} B={CG_BENCH_BATCH} "
        f"{CG_BENCH_ITERS} iterations: fused K2 solve {out['fused_iters_per_s']:.1f} iters/s "
        f"({s_f * 1e3 / CG_BENCH_ITERS:.3f} ms/iteration; both runs {times['fused']}), "
        f"K1 composition {out['composed_iters_per_s']:.1f} iters/s "
        f"({s_c * 1e3 / CG_BENCH_ITERS:.3f} ms/iteration; both runs {times['composed']}); "
        f"solutions agree to rel {rel:.3e}")
    if busy > 0:
        log(f"CG bench fused solve: device busy {busy / CG_BENCH_ITERS:.3f} ms/iteration "
            f"(profiled), idle share {max(0.0, 1 - busy / (s_f * 1e3)):.3f} of the unprofiled "
            "wall time: the host's launches and one synchronize per iteration")
    else:
        log("CG bench: the profiler saw no device time; idle share not measured")
    return out


# ---------------------------------------------------------------------------
# Phase 7: kernels against their plain versions, and their times
# ---------------------------------------------------------------------------


def _sparse_phi(w, offsets):
    """Φ as a CSR matrix (N, N), rows sorted: the library yardstick for K1."""
    import torch

    s, n = w.shape
    i = torch.arange(n, device=w.device)
    offs = torch.as_tensor(offsets, device=w.device)
    cols = torch.remainder(i[:, None] + offs[None, :], n)  # (N, S)
    cols, order = torch.sort(cols, dim=1)
    vals = torch.gather(w.T, 1, order)
    crow = torch.arange(0, s * n + 1, s, device=w.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
        return torch.sparse_csr_tensor(
            crow, cols.reshape(-1), vals.reshape(-1), (n, n), check_invariants=False
        )


def k2_check(label: str, w, w_shift, offs, mask, nv, v, launches=None) -> list:
    """K2a and K2b on one set of tensors: against their plain versions, a
    second launch bit-identical, and their times beside K1's at the same
    shape, the plain version's, the K1 composition's and a sparse-product
    yardstick's. Returns the two rows of the kernels line when ``launches``
    is given."""
    import torch

    from graphgp_tpu_torch.cuda_kernels import gram as k2
    from graphgp_tpu_torch.cuda_kernels import stencil as k1

    s, n = w.shape
    b = v.shape[0]
    neg = tuple(-o for o in offs)
    m = mask[None, :]

    t = k2.rmv_mask_cuda(w_shift, mask, v, neg)
    t_ref = k2.rmv_mask_plain(w_shift, mask, v, neg)
    err_a, rel_a = rel_err(t, t_ref)
    check(rel_a <= REL_TOL_K2, f"K2a {label}: rel err {rel_a}")
    check(torch.equal(t, k2.rmv_mask_cuda(w_shift, mask, v, neg)), f"K2a {label}: not repeatable")
    out, dot = k2.mv_epilogue_cuda(w, t, mask, v, nv, offs)
    out_ref, dot_ref = k2.mv_epilogue_plain(w, t, mask, v, nv, offs)
    err_b, rel_b = rel_err(out, out_ref)
    rel_dot = float(((dot - dot_ref).abs() / dot_ref.abs().clamp(min=1e-30)).max())
    check(rel_b <= REL_TOL_K2, f"K2b {label}: rel err {rel_b}")
    check(rel_dot <= REL_TOL_K2, f"K2b {label}: fused dot rel err {rel_dot}")
    out2, dot2 = k2.mv_epilogue_cuda(w, t, mask, v, nv, offs)
    check(torch.equal(out, out2) and torch.equal(dot, dot2), f"K2b {label}: not repeatable")
    check(torch.equal(out[:, mask == 0], v[:, mask == 0]), f"K2b {label}: identity rows changed")

    # K2a, K2b and K1 at the same shape, in turns (a, b, K1, K1, b, a); the
    # faster read of each
    fn_a = lambda: k2.rmv_mask_cuda(w_shift, mask, v, neg)
    fn_b = lambda: k2.mv_epilogue_cuda(w, t, mask, v, nv, offs)
    fn_k1 = lambda: k1.stencil_matvec_cuda(w, v, offs)
    reads = [cuda_ms(fn) for fn in (fn_a, fn_b, fn_k1, fn_k1, fn_b, fn_a)]
    ms_a, ms_b, ms_k1 = min(reads[0], reads[5]), min(reads[1], reads[4]), min(reads[2], reads[3])
    # K2b's kernel alone, its partials left unsummed (the wrapper adds them with torch.sum)
    ms_b_kernel = cuda_ms(lambda: k2.mv_epilogue_partials_cuda(w, t, mask, v, nv, offs))
    plain_a = cuda_ms(lambda: k2.rmv_mask_plain(w_shift, mask, v, neg), reps=5, warmup=1)
    plain_b = cuda_ms(lambda: k2.mv_epilogue_plain(w, t, mask, v, nv, offs), reps=5, warmup=1)
    # what the kernels fuse: a K1 launch plus the elementwise passes around it
    comp_a = cuda_ms(lambda: k1.stencil_matvec_cuda(w_shift, v * m, neg))

    def composed_b():
        o = k1.stencil_matvec_cuda(w, t, offs) * m + nv * (v * m) + (v - v * m)
        return o, (v * o).sum(dim=1)

    comp_b = cuda_ms(composed_b)
    # library yardstick: torch.sparse.mm on Φᵀ / Φ as CSR, plus the same elementwise work
    phi_t_csr = _sparse_phi(w_shift, neg)
    v_t, m_col = v.T.contiguous(), mask[:, None]
    lib_t = torch.sparse.mm(phi_t_csr, v_t * m_col)
    _, rel_lib = rel_err(lib_t.T, t_ref)
    check(rel_lib <= 1e-4, f"K2a {label}: sparse-product yardstick disagrees: rel {rel_lib}")
    lib_a = cuda_ms(lambda: torch.sparse.mm(phi_t_csr, v_t * m_col), reps=10, warmup=2)
    del phi_t_csr
    phi_csr = _sparse_phi(w, offs)
    t_t = t.T.contiguous()

    def library_b():
        o = m_col * torch.sparse.mm(phi_csr, t_t) + (nv * m_col) * v_t + (1.0 - m_col) * v_t
        return o, (v_t * o).sum(dim=0)

    _, rel_lib = rel_err(library_b()[0].T, out_ref)
    check(rel_lib <= 1e-4, f"K2b {label}: sparse-product yardstick disagrees: rel {rel_lib}")
    lib_b = cuda_ms(library_b, reps=10, warmup=2)
    del phi_csr
    bnd_a, by_a = bound_ms(4.0 * (s * n + 2 * b * n + n), 2.0 * s * b * n + b * n * s)
    bnd_b, by_b = bound_ms(4.0 * (s * n + 3 * b * n + n), 2.0 * s * b * n + 7.0 * b * n)
    log(f"K2a gram_rmv_mask {label} B={b} S={s} N={n}: {ms_a:.4f} ms (K1 at this shape "
        f"{ms_k1:.4f} ms; reads a, b, K1, K1, b, a: {', '.join(f'{r:.4f}' for r in reads)}), "
        f"plain {plain_a:.4f} ms, "
        f"mask pass + K1 {comp_a:.4f} ms, mask pass + torch.sparse.mm {lib_a:.4f} ms, "
        f"bound {bnd_a:.4f} ms ({by_a}); max abs err {err_a:.3e} (rel {rel_a:.3e})")
    log(f"K2b gram_mv_epilogue {label} B={b} S={s} N={n}: {ms_b:.4f} ms (the kernel alone, "
        f"partials unsummed: {ms_b_kernel:.4f} ms), plain {plain_b:.4f} ms, "
        f"K1 + epilogue passes {comp_b:.4f} ms, torch.sparse.mm + epilogue passes {lib_b:.4f} ms, "
        f"bound {bnd_b:.4f} ms ({by_b}); max abs err {err_b:.3e} (rel {rel_b:.3e}), "
        f"dot rel {rel_dot:.3e}; second launches bit-identical")
    if launches is None:
        return []
    common = {"route": "cuda", "source": "graphgp_tpu_torch/csrc/gram.cu"}
    return [
        {"name": "gram_rmv_mask", **common,
         "replaces": "graphgp_tpu/pallas_kernels/gram.py:200",
         "launches": launches["gram_rmv_mask"], "max_abs_err": err_a, "ms": ms_a,
         "plain_ms": plain_a, "bound_ms": bnd_a, "bound_by": by_a, "library_ms": lib_a},
        {"name": "gram_mv_epilogue", **common,
         "replaces": "graphgp_tpu/pallas_kernels/gram.py:218",
         "launches": launches["gram_mv_epilogue"], "max_abs_err": err_b, "ms": ms_b,
         "plain_ms": plain_b, "bound_ms": bnd_b, "bound_by": by_b, "library_ms": lib_b},
    ]


def log_k2_plans(label: str, offs: tuple) -> None:
    """K2's band plans: K2a's of the negated offsets, K2b's of the offsets."""
    from graphgp_tpu_torch.cuda_kernels import stencil as k1

    plan_a, plan_b = k1.plan_bands([-o for o in offs]), k1.plan_bands(list(offs))
    log(f"K2 band plans, {label} (S = {len(offs)}): K2a {plan_a.num_bands} bands of up to "
        f"{plan_a.band_rows} offsets, K2b {plan_b.num_bands} of up to {plan_b.band_rows}; "
        + "; ".join(f"B = {b}: {plan_a.tile(b)} columns a block, shared memory K2a "
                    f"{plan_a.smem_bytes(b, mask=True)} B, K2b {plan_b.smem_bytes(b)} B"
                    for b in (1, CG_BENCH_BATCH, 16)))


def k2_checks(device, flag: dict, scal: dict) -> list:
    """K2 at the scaling path's own tensors (the last fused solve of the run:
    ring N = 2^20, a 16-row chunk of the 64 pathwise residuals), which give
    the rows of the kernels line, and on the flagship's stencil at the CG
    bench shape for B in {1, 8, 16} and, at B = 16, with the offsets in
    dx-major order; K1 timed at each shape beside them; then a 20-iteration
    fused solve against the same loop over the plain versions."""
    import torch

    from graphgp_tpu_torch.cuda_kernels import gram as k2
    from graphgp_tpu_torch.cuda_kernels import stencil as k1
    from graphgp_tpu_torch.features import contract
    from graphgp_tpu_torch.gp import params as P

    call = scal["last_call"]
    phi, n = call["phi"], call["phi"].num_nodes
    offs = tuple(k1.center_offsets(phi.offsets, n).tolist())
    nv = call["noise_var"].detach().reshape(1)
    log_k2_plans("ring", offs)
    rows = k2_check("scaling path, ring", phi.w.contiguous(), phi.w_shift.contiguous(), offs,
                    call["mask"], nv, call["b_rhs"].contiguous(), launches=scal["launches"])

    feats, params = flag["feats"], flag["params"]
    with torch.no_grad():
        phi = contract(feats, params["modulator"])
        nv = P.noise_variance(params).reshape(1)
    n = feats.num_nodes
    offs = tuple(k1.center_offsets(feats.mats.offsets, n).tolist())
    mask = torch.zeros(n, device=device)
    mask[::2] = 1.0
    gen = torch.Generator(device=device).manual_seed(2)
    log_k2_plans("grid", offs)
    w, w_shift = phi.w.contiguous(), phi.w_shift.contiguous()
    for b in (1, CG_BENCH_BATCH, 16):
        v = torch.randn((b, n), generator=gen, device=device)
        k2_check("CG bench shape, grid", w, w_shift, offs, mask, nv, v)
    # the same offsets in dx-major order, the weight rows with them: the
    # planner sorts, so the time should not move
    dx_major = tuple(int(o) for o in k1.center_offsets(
        [dx + GRID_SIDE * dy for dx in range(-4, 5) for dy in range(-4, 5)
         if abs(dx) + abs(dy) <= 4], n))
    perm = [offs.index(o) for o in dx_major]
    k2_check("CG bench shape, grid, dx-major offsets", w[perm].contiguous(),
             w_shift[perm].contiguous(), dx_major, mask, nv, v)
    del w, w_shift
    rhs = torch.randn((CG_BENCH_BATCH, n), generator=gen, device=device) * mask[None, :]
    got = k2.gram_cg(phi, nv, mask, rhs, tol=0.0, max_iters=CG_BENCH_ITERS)
    ref = k2.gram_cg_plain(phi, nv, mask, rhs, tol=0.0, max_iters=CG_BENCH_ITERS)
    err, rel = rel_err(got.x, ref.x)
    log(f"K2 gram_cg vs gram_cg_plain, {CG_BENCH_ITERS} iterations at the CG bench shape: "
        f"max abs err {err:.3e} (rel {rel:.3e})")
    check(got.iterations == ref.iterations == CG_BENCH_ITERS, "gram_cg iteration count")
    check(rel <= 1e-4, f"gram_cg disagrees with gram_cg_plain: rel {rel}")
    check(torch.equal(got.x, k2.gram_cg(phi, nv, mask, rhs, tol=0.0,
                                        max_iters=CG_BENCH_ITERS).x),
          "gram_cg: a repeated solve is not bit-identical")
    return rows


def k1_checks(device, flag: dict, dw_launches: int) -> list:
    """K1 (forward and transposed at B = 1, 8, 16) and its dw kernel (B = 1
    and 16) on the flagship's own w: against their plain versions, dw
    bit-identical on repeat, the autograd of the two products through the
    new backward, and their times beside the plain versions', the bound and,
    for K1, torch.sparse.mm. Returns the kernels line's K1 and dw rows."""
    import torch

    from graphgp_tpu_torch.cuda_kernels import stencil as k1
    from graphgp_tpu_torch.features import contract

    feats = flag["feats"]
    with torch.no_grad():
        phi = contract(feats, flag["params"]["modulator"])
    w, w_shift = phi.w.contiguous(), phi.w_shift.contiguous()
    s, n = w.shape
    offs = k1.center_offsets(feats.mats.offsets, n).tolist()
    neg = [-o for o in offs]
    plan = k1.plan_bands(offs)
    log(f"K1 band plan: {plan.num_bands} bands, spreads "
        f"{[max(o for _, o in e) - lo for lo, e in plan.bands()]}; a block owns {plan.tile(1)} "
        f"columns and {plan.smem_bytes(1)} B of shared memory at B = 1, {plan.tile(16)} and "
        f"{plan.smem_bytes(16)} B at B = 16 (dw: {plan.smem_bytes(16, weights=False)} B)")
    gen = torch.Generator(device=device).manual_seed(0)
    k1_entry = dw_entry = None

    for b in (1, CG_BENCH_BATCH, 16):
        v = torch.randn((b, n), generator=gen, device=device)
        out = k1.stencil_matvec_cuda(w, v, offs)
        ref = k1.matvec_plain(w, v, offs)
        err, rel = rel_err(out, ref)
        check(rel <= REL_TOL_K1, f"K1 forward B={b}: rel err {rel}")
        out_t = k1.stencil_matvec_cuda(w_shift, v, neg)
        ref_t = torch.zeros_like(v)
        for si, off in enumerate(offs):  # Σ_s roll(w_s ⊙ v, +off_s): no shifted table
            ref_t = ref_t + torch.roll(w[si][None, :] * v, off, dims=-1)
        err_t, rel_t = rel_err(out_t, ref_t)
        check(rel_t <= REL_TOL_K1, f"K1 transpose B={b}: rel err {rel_t}")
        del ref_t
        # forward and transpose in turns (f, t, t, f); the faster read of each
        fwd = lambda: k1.stencil_matvec_cuda(w, v, offs)
        trn = lambda: k1.stencil_matvec_cuda(w_shift, v, neg)
        reads = [cuda_ms(fn) for fn in (fwd, trn, trn, fwd)]
        ms, ms_t = min(reads[0], reads[3]), min(reads[1], reads[2])
        plain = cuda_ms(lambda: k1.matvec_plain(w, v, offs), reps=5, warmup=1)
        phi_csr = _sparse_phi(w, offs)
        v_t = v.T.contiguous()
        lib_out = torch.sparse.mm(phi_csr, v_t).T
        _, rel_lib = rel_err(lib_out, ref)
        check(rel_lib <= 1e-4, f"sparse-product yardstick disagrees: rel {rel_lib}")
        lib = cuda_ms(lambda: torch.sparse.mm(phi_csr, v_t), reps=10, warmup=2)
        del phi_csr, lib_out
        bnd, by = bound_ms(4.0 * (s * n + 2 * b * n), 2.0 * s * b * n)
        log(f"K1 stencil_matvec B={b} S={s} N={n}: fwd {ms:.4f} ms, transpose {ms_t:.4f} ms "
            f"(reads f, t, t, f: {', '.join(f'{r:.4f}' for r in reads)}), "
            f"plain {plain:.4f} ms, torch.sparse.mm {lib:.4f} ms, bound {bnd:.4f} ms ({by}, "
            f"{bnd / ms:.2f} of it); max abs err fwd {err:.3e} (rel {rel:.3e}), transpose "
            f"{err_t:.3e} (rel {rel_t:.3e})")
        if b == 16:
            k1_entry = {
                "name": "stencil_matvec", "route": "cuda",
                "source": "graphgp_tpu_torch/csrc/stencil.cu",
                "replaces": "graphgp_tpu/pallas_kernels/stencil.py:176",
                "launches": flag["launches"]["stencil_matvec"], "max_abs_err": err,
                "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": lib,
            }

    for b in (1, 16):
        v = torch.randn((b, n), generator=gen, device=device)
        g = torch.randn((b, n), generator=gen, device=device)
        dw = k1.stencil_dw_cuda(v, g, offs)
        err, rel = rel_err(dw, k1._dw_matvec(v, g, offs))
        check(rel <= REL_TOL_K1, f"K1 dw B={b}: rel err {rel}")
        check(torch.equal(dw, k1.stencil_dw_cuda(v, g, offs)), f"K1 dw B={b}: not bit-identical")
        _, rel_n = rel_err(k1.stencil_dw_cuda(v, g, neg), k1._dw_matvec(v, g, neg))
        check(rel_n <= REL_TOL_K1, f"K1 dw B={b} under -offsets: rel err {rel_n}")
        del dw

        # the operator's two products, differentiated through the new backward
        wk, sk = w.clone().requires_grad_(True), w_shift.clone().requires_grad_(True)
        vk = v.clone().requires_grad_(True)
        (k1.stencil_matvec(wk, k1.stencil_matvec(sk, vk, neg, wk), offs, sk) * g).sum().backward()
        wp, sp = w.clone().requires_grad_(True), w_shift.clone().requires_grad_(True)
        vp = v.clone().requires_grad_(True)
        (k1.matvec_plain(wp, k1.matvec_plain(sp, vp, neg), offs) * g).sum().backward()
        rels = [rel_err(a.grad, p.grad)[1] for a, p in ((wk, wp), (sk, sp), (vk, vp))]
        check(max(rels) <= REL_TOL_K1, f"K1 autograd B={b}: dw, dw_shift, dv rel {rels}")
        del wk, sk, vk, wp, sp, vp

        # read before and after the plain version; the faster read
        reads = [cuda_ms(lambda: k1.stencil_dw_cuda(v, g, offs))]
        plain = cuda_ms(lambda: k1._dw_matvec(v, g, offs), reps=5, warmup=1)
        reads.append(cuda_ms(lambda: k1.stencil_dw_cuda(v, g, offs)))
        ms = min(reads)
        bnd, by = bound_ms(4.0 * (s * n + 2 * b * n), 2.0 * s * b * n)
        log(f"K1 dw stencil_dw B={b} S={s} N={n}: {ms:.4f} ms (reads {reads[0]:.4f}, "
            f"{reads[1]:.4f}), plain {plain:.4f} ms, no single "
            f"PyTorch call, bound {bnd:.4f} ms ({by}, {bnd / ms:.2f} of it); max abs err "
            f"{err:.3e} (rel {rel:.3e}), under -offsets rel {rel_n:.3e}; second launch "
            f"bit-identical; autograd dw / dw_shift / dv rel {rels[0]:.3e} / {rels[1]:.3e} / "
            f"{rels[2]:.3e}")
        if b == 16:
            dw_entry = {
                "name": "stencil_dw", "route": "cuda",
                "source": "graphgp_tpu_torch/csrc/stencil.cu",
                "replaces": "graphgp_tpu/pallas_kernels/stencil.py:201",
                "launches": dw_launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": None,
            }
    return [k1_entry, dw_entry]


def _k3_measure(label: str, cols, vals, offsets: np.ndarray, device, stencil=None) -> dict:
    """K3 on one ELL: equal bit for bit to its plain version (and to the
    path's own ``stencil`` where given), its time beside the plain version's
    and the bound."""
    import torch

    from graphgp_tpu_torch.cuda_kernels import stencil_build as k3

    l, n, r = cols.shape
    s = offsets.size
    off_t = torch.from_numpy(offsets).to(device)
    sched = k3.plan(n, r, s, k3.offsets_span(torch.from_numpy(offsets)),
                    aligned=cols.data_ptr() % 16 == 0 and vals.data_ptr() % 16 == 0)
    out = k3.ell_to_stencil_cuda(cols, vals, off_t, sched)
    ref = k3.ell_to_stencil_plain(cols, vals, off_t)
    check(torch.equal(out, ref), f"K3 {label} differs from its plain version")
    if stencil is not None:
        check(torch.equal(out, stencil), f"K3 {label} differs from the path's stencil")
    err = float((out - ref).abs().max())
    del out, ref
    # the calls back to back: at a tenth of a millisecond and more a launch,
    # the host's launch path hides behind the kernels
    ms = cuda_ms(lambda: k3.ell_to_stencil_cuda(cols, vals, off_t, sched), reps=5, warmup=1)
    plain = cuda_ms(lambda: k3.ell_to_stencil_plain(cols, vals, off_t), reps=2, warmup=1)
    live = int((vals != 0).sum())
    # a live entry: its offset, the range test, one lookup (or the binary
    # search's halvings) and the slot's add
    lookups = 1 if sched.lookup else math.ceil(math.log2(max(s, 2)))
    bnd, by = bound_ms(8.0 * l * n * r + 4.0 * l * s * n, live, int_ops=live * (lookups + 3))
    log(f"K3 ell_to_stencil {label} L={l} N={n} R={r} S={s} ({live} live entries; {sched}): "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}, {bnd / ms:.2f} of it); "
        f"exactly equal")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by}


def k3_check(device, flag: dict) -> dict:
    """K3 at the flagship's ELL (the kernels line's row), and at the scaling
    path's largest ring, whose narrow rows take the other schedule."""
    import torch

    from graphgp_tpu_torch.data import synthetic
    from graphgp_tpu_torch.preprocessor import preprocess_graph
    from graphgp_tpu_torch.walker import WalkConfig

    feats, mats = flag["feats"], flag["mats"]
    row = _k3_measure("flagship", mats.cols, mats.vals, feats.mats.offsets, device,
                      stencil=feats.mats.vals)
    # the scaling path's top size at its defaults (walks_per_node 100, p_halt 0.1, L 3)
    trace: dict = {}
    ring = preprocess_graph(synthetic.generate("ring", SCALING_SIZES[-1], seed=DATA_SEED)
                            ["adjacency"], WalkConfig(100, 0.1, 3), seed=DATA_SEED,
                            cache_dir=None, layout="auto", device=device, trace=trace)
    _k3_measure("scaling path's ring", trace["ell"].cols, trace["ell"].vals, ring.mats.offsets,
                device, stencil=ring.mats.vals)
    del ring, trace
    torch.cuda.empty_cache()
    return {
        "name": "ell_to_stencil", "route": "cuda",
        "source": "graphgp_tpu_torch/csrc/stencil_build.cu",
        "replaces": "graphgp_tpu/pallas_kernels/stencil_build.py:73",
        "launches": flag["launches"]["ell_to_stencil"], **row, "library_ms": None,
    }


# ---------------------------------------------------------------------------
# Phase 8: the dense regime (kernels.py, the ablation and traffic protocols, K4)
# ---------------------------------------------------------------------------


def dense_small_agreement(device) -> None:
    """The quickstart kernel on the 4-node cycle and the diffusion estimate at
    20000 walks per node: the card's path (K4) against the plain CPU path, and
    the estimate against the exact heat kernel."""
    import numpy as np

    import graphgp_tpu_torch as gg

    cycle = np.zeros((4, 4))
    for u, v in [(0, 1), (1, 2), (2, 3), (3, 0)]:
        cycle[u, v] = cycle[v, u] = 1.0
    k = {d: gg.fast_general_grf_kernel(cycle, modulator_vector=[1.0, 0.5, 0.25],
                                       walks_per_node=50, p_halt=0.1, device=d).cpu()
         for d in ("cpu", device)}
    err, rel = rel_err(k[device], k["cpu"])
    log(f"dense small-input agreement fast_general_grf_kernel (4-cycle, wpn 50): "
        f"max abs err {err:.3e} (rel {rel:.3e})")
    check(rel <= 1e-5, f"quickstart kernel, card against CPU: rel {rel}")
    check(float((k[device] - k[device].T).abs().max()) <= 1e-6, "quickstart kernel not symmetric")

    ring = np.zeros((64, 64))
    for i in range(64):
        ring[i, (i + 1) % 64] = ring[(i + 1) % 64, i] = 1.0
    est = {d: gg.fast_diffusion_grf_kernel(ring, beta=1.0, walks_per_node=20000, device=d).cpu()
           for d in ("cpu", device)}
    err, rel = rel_err(est[device], est["cpu"])
    exact_err = float((est[device] - gg.diffusion_kernel(ring, beta=1.0, device=device).cpu())
                      .abs().max())
    log(f"dense small-input agreement fast_diffusion_grf_kernel (64-ring, wpn 20000): card "
        f"against CPU max abs err {err:.3e} (rel {rel:.3e}); against diffusion_kernel {exact_err:.4f}")
    # the plain path adds 20000 loads per cell, each divided by W first, one
    # after the other in float32 (its step 0 reads 1.0001, and its K is 1.6e-4
    # from a float64 sum of the same walks); the kernel divides the sum
    check(rel <= 1e-3, f"diffusion estimate, card against CPU: rel {rel}")
    check(exact_err <= 0.05, f"diffusion estimate is {exact_err} from the exact heat kernel")


def _timed_calls(targets: dict):
    """Wrap each ``(module, name)`` of ``targets`` (label -> pair), which the
    CLIs reach through their modules, to add up the seconds spent in it and
    each call's own seconds (each call ended by a device synchronize).
    Returns (totals, per-call seconds, restore)."""
    import torch

    totals = {label: 0.0 for label in targets}
    calls = {label: [] for label in targets}
    originals = {label: getattr(mod, name) for label, (mod, name) in targets.items()}

    def timed(label, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            totals[label] += dt
            calls[label].append(dt)
            return out
        return wrapper

    for label, (mod, name) in targets.items():
        setattr(mod, name, timed(label, originals[label]))

    def restore():
        for label, (mod, name) in targets.items():
            setattr(mod, name, originals[label])

    return totals, calls, restore


def _timed_dense_calls():
    """``_timed_calls`` of the step matrices and the fits the dense CLIs
    make: ``kernels.features_for_adjacency``, ``gp.exact.fit``,
    ``gp.spectral.fit`` and the GCN baseline's ``fit_gcn``."""
    from graphgp_tpu_torch import baselines, kernels
    from graphgp_tpu_torch.gp import exact, spectral

    totals, _, restore = _timed_calls({
        "features": (kernels, "features_for_adjacency"), "exact_fit": (exact, "fit"),
        "spectral_fit": (spectral, "fit"), "gcn_fit": (baselines, "fit_gcn")})
    return totals, restore


def check_no_error_rows(name: str, records: list) -> None:
    """No record of a phase may carry an error: a sweep records a failed cell
    as a row and goes on, so a failure on the card would otherwise pass."""
    bad = [r for r in records if "error" in r]
    check(not bad, f"{name}: {len(bad)} error row(s), the first: {bad[0]['error'][-2000:]}"
          if bad else "")


def _run_dense_cli(name: str, main_fn, argv: list, device) -> tuple:
    """One dense-regime CLI through its ``main``, its CSVs written to a
    temporary directory: (records, K4 launches, seconds)."""
    import tempfile

    import torch

    from graphgp_tpu_torch.cuda_kernels import walker as k4

    totals, restore = _timed_dense_calls()
    k4.launches = 0
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as results_dir:
            records = main_fn([*argv, "--device", device, "--results-dir", results_dir])
    finally:
        restore()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = k4.launches
    gcn = f", GCN Adam fits {totals['gcn_fit']:.2f} s" if totals["gcn_fit"] else ""
    log(f"{name}: {total_s:.2f} s in all; step matrices (K4) {totals['features']:.3f} s over "
        f"{launches} launches, L-BFGS fits {totals['exact_fit']:.2f} s, spectral Adam fits "
        f"{totals['spectral_fit']:.2f} s{gcn}")
    check(launches > 0, f"K4 was not launched by {name}")
    check_no_error_rows(name, records)
    return records, launches, total_s


def ablation_protocol(device) -> int:
    import numpy as np

    from graphgp_tpu_torch.cli import ablation

    log(f"ablation protocol: reference settings (30x30 mesh, beta 10, amplitude 10, noise 0.5, "
        f"p_halt 0.01, L 10, walks 1/10/100/1000); depth cut: {DENSE_SEEDS} seed (the protocol "
        f"runs 3), {ABLATION_TRAIN_STEPS} Adam / L-BFGS steps per fit (it takes 1000)")
    records, launches, _ = _run_dense_cli(
        "ablation", ablation.main,
        ["--seeds", str(DENSE_SEEDS), "--train-steps", str(ABLATION_TRAIN_STEPS)], device)
    walks = ablation.build_parser().parse_args([]).walks
    check(launches == DENSE_SEEDS * len(walks) * 2, f"ablation: {launches} K4 launches")
    check(sum(r["mode"] == "exact_diffusion" for r in records) == DENSE_SEEDS,
          "ablation: the exact-diffusion row is missing")
    for r in records:
        check(np.isfinite(r["rmse"]) and np.isfinite(r["nlpd"]),
              f"ablation: {r['mode']} wpn {r['walks_per_node']} not finite")
    fro = {m: [float(np.mean([r["kernel_fro_rel"] for r in records
                              if r["mode"] == m and r["walks_per_node"] == w])) for w in walks]
           for m in ("principled", "ablation")}
    log(f"ablation kernel_fro_rel over walks {walks}: principled "
        f"{[round(x, 4) for x in fro['principled']]}, ad-hoc {[round(x, 4) for x in fro['ablation']]}")
    check(all(a > b for a, b in zip(fro["principled"], fro["principled"][1:])),
          "ablation: the principled estimator's kernel error does not fall with walks_per_node")
    check(fro["principled"][-1] < fro["ablation"][-1],
          "ablation: the principled kernel error is not below the ad-hoc one's at the top wpn")
    return launches


def traffic_protocol(device) -> int:
    import numpy as np

    from graphgp_tpu_torch.cli import regression

    defaults = regression.build_parser().parse_args([])
    log(f"traffic protocol: PEMS sensor graph, {defaults.num_train} train, p_halt {defaults.p_halt}, "
        f"L {defaults.max_walk_length}, walks {defaults.walks}, two restarts per fit; depth cut: "
        f"{DENSE_SEEDS} seed (the protocol runs 3), {PEMS_TRAIN_STEPS} L-BFGS steps per fit (it "
        f"takes {defaults.train_steps})")
    records, launches, _ = _run_dense_cli(
        "traffic_pems", regression.main,
        ["--pems-npz", PEMS_NPZ, "--seeds", str(DENSE_SEEDS), "--train-steps", str(PEMS_TRAIN_STEPS)],
        device)
    check(launches == DENSE_SEEDS * len(defaults.walks), f"traffic: {launches} K4 launches")
    top = max(defaults.walks)

    def rmse(kernel, wpn):
        return float(np.mean([r["rmse"] for r in records
                              if r["kernel"] == kernel and r["walks_per_node"] == wpn]))

    for r in records:
        check(np.isfinite(r["rmse"]) and np.isfinite(r["nlpd"]),
              f"traffic: {r['kernel']} wpn {r['walks_per_node']} not finite")
    floor, transplant = rmse("pofm_diffusion", 0), rmse("grf_diffusion_transplant", top)
    log(f"traffic (PEMS) rmse: exact_diffusion {rmse('exact_diffusion', 0):.4f}, pofm_diffusion "
        f"{floor:.4f}; transplant arm wpn 1 {rmse('grf_diffusion_transplant', 1):.4f} -> wpn {top} "
        f"{transplant:.4f} ({transplant / floor:.1f}x the pofm_diffusion rmse; margin "
        f"{TRANSPLANT_MARGIN:.0f}x); refit arms at wpn {top}: grf_diffusion "
        f"{rmse('grf_diffusion', top):.4f}, grf_free {rmse('grf_free', top):.4f}")
    check(transplant <= TRANSPLANT_MARGIN * floor,
          f"traffic: transplant rmse {transplant} is over {TRANSPLANT_MARGIN}x the floor {floor}")
    check(transplant < rmse("grf_diffusion_transplant", 1),
          "traffic: the transplant arm does not improve from wpn 1 to the top wpn")

    log(f"traffic protocol, the script's default grid (N {defaults.n_nodes}): depth cut: "
        f"{DENSE_SEEDS} seed, walks {list(GRID_WALKS)} (the protocol sweeps {defaults.walks}), "
        f"{GRID_TRAIN_STEPS} L-BFGS steps per fit (it takes {defaults.train_steps})")
    grid_records, grid_launches, _ = _run_dense_cli(
        "traffic_grid", regression.main,
        ["--seeds", str(DENSE_SEEDS), "--walks", *map(str, GRID_WALKS),
         "--train-steps", str(GRID_TRAIN_STEPS)], device)
    check(grid_launches == DENSE_SEEDS * len(GRID_WALKS), f"traffic grid: {grid_launches} K4 launches")
    for r in grid_records:
        check(np.isfinite(r["rmse"]) and np.isfinite(r["nlpd"]),
              f"traffic grid: {r['kernel']} wpn {r['walks_per_node']} not finite")
    by = {(r["kernel"], r["walks_per_node"]): r["rmse"] for r in grid_records}
    log(f"traffic (grid 900) rmse: exact_diffusion {by[('exact_diffusion', 0)]:.4f}, pofm_diffusion "
        f"{by[('pofm_diffusion', 0)]:.4f}; transplant arm "
        f"{[round(by[('grf_diffusion_transplant', w)], 4) for w in GRID_WALKS]}, grf_free "
        f"{[round(by[('grf_free', w)], 4) for w in GRID_WALKS]} over walks {list(GRID_WALKS)}")
    check(by[("grf_diffusion_transplant", GRID_WALKS[-1])] < by[("grf_diffusion_transplant", 1)],
          "traffic grid: the transplant arm does not improve with walks_per_node")
    return launches + grid_launches


# ---------------------------------------------------------------------------
# Phase 10: K4 at this slice's shapes: the traffic CLI on the PEMS-BAY
# dataset with the GCN baseline, the wind protocol, SVGP classification
# ---------------------------------------------------------------------------


def _jax_rows(path: str, **match) -> list:
    """Rows of one of the JAX package's result CSVs (its records on its own
    chip) whose fields equal ``match`` (compared as text)."""
    import csv

    with open(path, newline="") as fh:
        return [r for r in csv.DictReader(fh)
                if all(r.get(k) == str(v) for k, v in match.items())]


@contextlib.contextmanager
def data_root():
    """A temporary directory whose empty ``raw`` subdirectory GRAPHGP_DATA_ROOT
    names while it is open: the raw-data root the dataset loader insists on
    (it reads the shipped cache under processed_data/ and nothing there)."""
    import os
    import tempfile

    saved = os.environ.get("GRAPHGP_DATA_ROOT")
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "raw"))
        os.environ["GRAPHGP_DATA_ROOT"] = os.path.join(tmp, "raw")
        try:
            yield tmp
        finally:
            if saved is None:
                os.environ.pop("GRAPHGP_DATA_ROOT", None)
            else:
                os.environ["GRAPHGP_DATA_ROOT"] = saved


def traffic_dataset_path(device) -> int:
    """The traffic CLI on the PEMS-BAY dataset through the loader, with the
    GCN baseline, at the JAX PEMS-BAY record's settings for one seed and one
    walks_per_node."""
    import numpy as np

    from graphgp_tpu_torch.cli import regression

    log(f"traffic protocol, dataset graph: --graph-type pems_bay through the loader, obs-noise "
        f"{PEMS_BAY_OBS_NOISE}, walks {PEMS_BAY_WALKS}, the GCN baseline ({PEMS_BAY_RECORD}: the "
        f"same settings, 3 seeds, walks 1..8192); depth cut: 1 seed, 1 walks_per_node")
    with data_root():
        records, launches, _ = _run_dense_cli(
            "traffic_pems_bay_dataset", regression.main,
            ["--graph-type", "pems_bay", "--obs-noise", str(PEMS_BAY_OBS_NOISE),
             "--walks", str(PEMS_BAY_WALKS), "--seeds", "1", "--gnn-baseline"], device)
    check(launches == 1, f"traffic pems_bay: {launches} K4 launches")
    for r in records:
        check(np.isfinite(r["rmse"]) and (r["kernel"] in ("gcn", "grf_diffusion_transplant")
                                          or np.isfinite(r["nlpd"])),
              f"traffic pems_bay: {r['kernel']} not finite")
    by = {(r["kernel"], r["walks_per_node"]): r["rmse"] for r in records}
    check(("gcn", 0) in by, "traffic pems_bay: no gcn row")
    ref = {(r["kernel"], int(r["walks_per_node"])): float(r["rmse"])
           for r in _jax_rows(PEMS_BAY_RECORD, seed=0)}
    log("traffic (PEMS-BAY dataset) rmse, seed 0, beside the JAX record's seed 0: " + ", ".join(
        f"{k}{f' wpn {w}' if w else ''} {v:.4f} ({ref.get((k, w), float('nan')):.4f})"
        for (k, w), v in by.items()))
    return launches


def wind_path(device) -> int:
    """cli.wind.main on the synthetic 19x36 sphere grid (N 684, 290 track
    nodes), walks WIND_WALKS, both kernels, one seed, the CLI's 300 Adam steps
    and 200 pathwise samples; K4's counter zeroed just before and read just
    after."""
    import tempfile

    import numpy as np
    import torch

    from graphgp_tpu_torch.cli import wind
    from graphgp_tpu_torch.cuda_kernels import walker as k4
    from graphgp_tpu_torch.gp import iterative

    defaults = wind.build_parser().parse_args([])
    log(f"wind: synthetic {defaults.n_lat}x{defaults.n_lon} sphere grid, walks {list(WIND_WALKS)}, "
        f"kinds {defaults.kinds}, p_halt {defaults.p_halt}, L {defaults.max_walk_length}, "
        f"{defaults.train_steps} Adam steps, {defaults.num_pathwise_samples} pathwise samples; depth "
        f"cut: 1 seed of {defaults.seeds} ({WIND_RECORD}: 1000 steps, walks 32..8192)")
    totals, calls, restore = _timed_calls({"fit": (iterative, "fit"),
                                           "predict": (iterative, "pathwise_predict")})
    k4.launches = 0
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as d:
            records = wind.main(["--walks", *map(str, WIND_WALKS), "--seeds", "1",
                                 "--device", device, "--results-dir", d])
    finally:
        restore()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = k4.launches
    check_no_error_rows("wind", records)
    ref = {(r["kernel"], int(r["walks_per_node"])): r for r in _jax_rows(WIND_RECORD, seed=0)}
    for r, fit_s, pred_s in zip(records, calls["fit"], calls["predict"]):
        j = ref.get((r["kernel"], r["walks_per_node"]))
        beside = f" (JAX record, 1000 steps: {float(j['rmse']):.4f} / {float(j['nlpd']):.4f})" if j else ""
        log(f"wind {r['kernel']} wpn {r['walks_per_node']}: fit {fit_s:.2f} s, predict "
            f"{pred_s:.3f} s, rmse / nlpd {r['rmse']:.4f} / {r['nlpd']:.4f}{beside}")
    log(f"wind: {total_s:.2f} s in all (fits {totals['fit']:.2f} s, predictions "
        f"{totals['predict']:.2f} s); K4 launches {launches}; {card_line()}")
    check(len(records) == len(WIND_WALKS) * len(defaults.kinds), f"wind: {len(records)} records")
    for r in records:
        check(np.isfinite(r["rmse"]) and np.isfinite(r["nlpd"]),
              f"wind: {r['kernel']} wpn {r['walks_per_node']} not finite")
    check(launches == len(WIND_WALKS), f"wind: {launches} K4 launches")
    free = {r["walks_per_node"]: r["rmse"] for r in records if r["kernel"] == "free"}
    top, low = max(WIND_WALKS), min(WIND_WALKS)
    check(free[top] < free[low], f"wind: free rmse at wpn {top} {free[top]} is not below "
          f"wpn {low}'s {free[low]}")
    check(free[top] < 1.0, f"wind: free rmse at wpn {top} is {free[top]} (standardized targets)")
    return launches


def svgp_card_against_cpu(device) -> None:
    """``svgp._latent_posterior`` and ``svgp.elbo`` on the same DenseFeatures
    and parameters, card against CPU, at the classification cell's shapes
    (N 2485, 1988 train, M 994, 7 classes; walks_per_node 64 on the CPU)."""
    import numpy as np
    import torch

    from graphgp_tpu_torch.cli.classification import synthetic_community_graph
    from graphgp_tpu_torch.features import DenseFeatures
    from graphgp_tpu_torch.gp import svgp
    from graphgp_tpu_torch.kernels import features_for_adjacency

    adj, labels = synthetic_community_graph(CLASS_NODES, CLASS_CLASSES, 0)
    rng = np.random.default_rng(0)
    perm = rng.permutation(CLASS_NODES)
    tr = np.sort(perm[:CLASS_TRAIN])
    ind = np.sort(rng.choice(tr, CLASS_TRAIN // 2, replace=False))
    cpu = features_for_adjacency(adj, 42, walks_per_node=64, p_halt=0.1, max_walk_length=5,
                                 device="cpu")
    card = DenseFeatures(cpu.step_matrices.to(device))
    gen = torch.Generator().manual_seed(0)
    params = svgp.init_variational("free", 5, ind.size, CLASS_CLASSES, generator=gen)
    params["q_mu"] = torch.randn(params["q_mu"].shape, generator=gen)
    params["q_sqrt"] = params["q_sqrt"] + 0.01 * torch.randn(params["q_sqrt"].shape,
                                                             generator=gen).tril(-1)
    idx = {d: (torch.from_numpy(ind).to(d), torch.from_numpy(tr).to(d)) for d in ("cpu", device)}
    y = torch.from_numpy(labels[tr].astype(np.int64))
    on = {k: v.to(device) for k, v in params.items()}
    post = svgp._latent_posterior(cpu, params, *idx["cpu"], "free")
    post_c = svgp._latent_posterior(card, on, *idx[device], "free")
    _, rel_m = rel_err(post_c.mean.cpu(), post.mean)
    _, rel_v = rel_err(post_c.var.cpu(), post.var)
    e = float(svgp.elbo(cpu, params, *idx["cpu"], y, kind="free", likelihood="robustmax"))
    e_c = float(svgp.elbo(card, on, *idx[device], y.to(device), kind="free", likelihood="robustmax"))
    rel_e = abs(e_c - e) / abs(e)
    log(f"SVGP card against CPU (N {CLASS_NODES}, M {ind.size}, {tr.size} train, "
        f"{CLASS_CLASSES} classes): posterior mean rel {rel_m:.2e}, var rel {rel_v:.2e}, robustmax "
        f"ELBO {e_c:.3f} against {e:.3f} (rel {rel_e:.2e}); tolerance {REL_TOL_SVGP:.0e}")
    check(max(rel_m, rel_v, rel_e) <= REL_TOL_SVGP,
          f"SVGP card against CPU: rel {max(rel_m, rel_v, rel_e)}")


def classification_path(device) -> int:
    """cli.classification.main on the synthetic community graph at Cora's
    shape, the JAX Cora record's settings, one seed, the free and
    exact_diffusion kernels; K4's counter zeroed just before each and read
    just after."""
    import tempfile

    import numpy as np
    import torch

    from graphgp_tpu_torch.cli import classification
    from graphgp_tpu_torch.cuda_kernels import walker as k4
    from graphgp_tpu_torch.gp import svgp

    log(f"classification: synthetic community graph at Cora's shape (N {CLASS_NODES}, "
        f"{CLASS_CLASSES} classes, 80/20 split, M = train/2), {' '.join(CLASS_ARGV)}; depth cut: "
        f"1 seed of 5 (the JAX records: real Cora, {CLASS_RECORDS})")
    launches = 0
    for kind, record in zip(("free", "exact_diffusion"), CLASS_RECORDS):
        totals, calls, restore = _timed_calls({"fit": (svgp, "fit")})
        k4.launches = 0
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory() as d:
                records = classification.main([*CLASS_ARGV, "--kernel-kind", kind,
                                               "--device", device, "--results-dir", d])
        finally:
            restore()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        check_no_error_rows(f"classification {kind}", records)
        (r,) = records
        j = _jax_rows(record, seed=0)[0]
        log(f"classification {kind}: {total_s:.2f} s in all, fits (two restarts) "
            f"{[round(x, 2) for x in calls['fit']]} s; accuracy {r['accuracy']:.4f}, test NLL "
            f"{r['test_nll']:.4f}, ELBO {r['final_elbo']:.1f} (n_train {r['n_train']}, n_test "
            f"{r['n_test']}, M {r['num_inducing']}); the JAX record on real Cora, seed 0: "
            f"{float(j['accuracy']):.4f}, {float(j['test_nll']):.4f}, "
            f"{float(j['final_elbo']):.1f}; K4 launches {k4.launches}; {card_line()}")
        check(all(np.isfinite(r[k]) for k in ("accuracy", "test_nll", "final_elbo")),
              f"classification {kind}: not finite")
        check(r["accuracy"] >= 0.5, f"classification {kind}: accuracy {r['accuracy']}")
        check((r["n_train"], r["n_test"], r["num_inducing"]) == (CLASS_TRAIN, CLASS_NODES -
                                                                  CLASS_TRAIN, CLASS_TRAIN // 2),
              f"classification {kind}: split {r['n_train']}/{r['n_test']}/{r['num_inducing']}")
        check(k4.launches == (1 if kind == "free" else 0),
              f"classification {kind}: {k4.launches} K4 launches")
        launches += k4.launches
    return launches


def _k4_live_steps(graph, seed, cfg) -> tuple:
    """(transitions tried, transitions taken) by this run's walks, counted
    from the plain walker's log over blocks of start nodes: a walk tries a
    transition at every step it is alive at, bar the last, and takes the ones
    it survives."""
    from graphgp_tpu_torch.pipeline import DEFAULT_LOG_BUDGET_BYTES, auto_block_size
    from graphgp_tpu_torch.walker import sample_walk_log

    n = graph.num_nodes
    block = auto_block_size(n, cfg, DEFAULT_LOG_BUDGET_BYTES)
    alive = None
    for start in range(0, n, block):
        lg = sample_walk_log(graph, seed, cfg, node_offset=start,
                             num_start_nodes=min(block, n - start))
        counts = (lg.loads != 0).sum(dim=(1, 2))
        alive = counts if alive is None else alive + counts
    alive = alive.tolist()
    return sum(alive[:-1]), sum(alive[1:])


def k4_check(label: str, graph, seed: int, cfg, reps: int, plain_reps: int) -> dict:
    """K4 on one graph: against its plain version, step 0 exactly the
    identity, a second launch beside the first, and its time beside the plain
    version's and the bound from this run's walks."""
    import torch

    from graphgp_tpu_torch.cuda_kernels import walker as k4

    n, d = graph.neighbors.shape
    w, steps = cfg.walks_per_node, cfg.max_walk_length
    out = k4.sample_dense_step_matrices_cuda(graph, seed, cfg)
    again = k4.sample_dense_step_matrices_cuda(graph, seed, cfg)
    torch.cuda.synchronize()
    ref = k4.sample_dense_step_matrices_plain(graph, seed, cfg)
    err, rel = rel_err(out, ref)
    check(out.shape == (steps, n, n), f"K4 {label}: shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"K4 {label}: not finite")
    check(rel <= REL_TOL_K4, f"K4 {label}: rel err {rel}")
    check(torch.equal(out[0], torch.eye(n, device=out.device)), f"K4 {label}: M[0] is not I")
    rep_err, rep_rel = rel_err(again, out)
    check(rep_rel <= REL_TOL_K4, f"K4 {label}: a second launch differs by rel {rep_rel}")
    repeat = ("bit-identical" if rep_err == 0.0 else
              f"max abs diff {rep_err:.3e} (rel {rep_rel:.3e}): float atomics, summation order")
    del again, ref
    run = lambda: k4.sample_dense_step_matrices_cuda(graph, seed, cfg)
    ms = cuda_ms(run, reps=reps, warmup=1)
    alone = graph_ms(run, reps=reps)
    check_alone(f"K4 {label}", alone, ms)
    plain = cuda_ms(lambda: k4.sample_dense_step_matrices_plain(graph, seed, cfg),
                    reps=plain_reps, warmup=1)
    tried, taken = _k4_live_steps(graph, seed, cfg)
    nbytes = 4.0 * (2 * n * d + n) + 4.0 * steps * n * n
    uniforms = tried + taken
    int_ops = K4_INT_OPS_PER_UNIFORM * uniforms + K4_INT_OPS_TAKEN * taken
    fp_ops = (K4_FP_OPS_PER_UNIFORM * uniforms + K4_FP_OPS_TRIED * tried
              + (K4_FP_OPS_TAKEN_ABLATION if cfg.ablation else K4_FP_OPS_TAKEN) * taken
              + steps * n * n)
    bnd, by = bound_ms(nbytes, fp_ops, int_ops)
    log(f"K4 walk_step_matrices {label} N={n} D={d} W={w} L={steps} p_halt={cfg.p_halt} "
        f"ablation={cfg.ablation} ({k4.block_threads(w, steps * n)} threads a block): kernel "
        f"alone (graph replay) {alone:.4f} ms, wrapper {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bnd:.4f} ms "
        f"({by}: {nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {tried} transitions tried, {taken} taken, "
        f"{int_ops:.3e} int32 operations at {INT32_OPS_PER_S / 1e12:.2f} T/s "
        f"{int_ops / INT32_OPS_PER_S * 1e3:.4f} ms, {fp_ops:.3e} fp32 at "
        f"{FP32_OPS_PER_S / 1e12:.0f} T/s {fp_ops / FP32_OPS_PER_S * 1e3:.4f} ms; kernel alone "
        f"{bnd / alone:.2f} of it), {n * w * 1e3 / alone:,.0f} walks/s; max abs err {err:.3e} "
        f"(rel {rel:.3e}); M[0] == I exactly; second launch {repeat}")
    return {"max_abs_err": err, "ms": alone, "wrapper_ms": ms, "plain_ms": plain,
            "bound_ms": bnd, "bound_by": by}


def k4_checks(device, launches: int) -> dict:
    """K4 at the dense paths' own shapes and at the edge of its regime. The
    row of the kernels line is the ablation protocol's principled cell."""
    import numpy as np

    from graphgp_tpu_torch.cli.classification import synthetic_community_graph
    from graphgp_tpu_torch.cli.wind import build_sphere_grid_graph
    from graphgp_tpu_torch.data import database, synthetic
    from graphgp_tpu_torch.graphs import pack_dense, pack_laplacian
    from graphgp_tpu_torch.walker import WalkConfig

    mesh = synthetic._grid_adjacency(30)
    row = k4_check("ablation protocol, principled", pack_laplacian(mesh.toarray()).to(device), 142,
                   WalkConfig(1000, 0.01, 10, ablation=False), reps=20, plain_reps=3)
    k4_check("ablation protocol, ad-hoc load on the raw adjacency",
             pack_dense(mesh.toarray()).to(device), 142,
             WalkConfig(1000, 0.01, 10, ablation=True), reps=20, plain_reps=3)
    pems, _, _ = database._load_csr_npz(PEMS_NPZ)
    k4_check("traffic protocol, PEMS graph", pack_laplacian(pems).to(device), 42,
             WalkConfig(1024, 0.1, 10), reps=20, plain_reps=3)
    k4_check("traffic protocol, PEMS graph, one walk", pack_laplacian(pems).to(device), 42,
             WalkConfig(1, 0.1, 10), reps=20, plain_reps=3)
    lat = np.linspace(-90, 90, 19)
    lon = np.linspace(-180, 180, 36, endpoint=False)
    k4_check("wind protocol, 19x36 sphere grid", pack_laplacian(
        build_sphere_grid_graph(lat, lon)).to(device), 42, WalkConfig(max(WIND_WALKS), 0.1, 5),
        reps=10, plain_reps=1)
    community, _ = synthetic_community_graph(CLASS_NODES, CLASS_CLASSES, 0)
    k4_check("classification, community graph at Cora's shape",
             pack_laplacian(community).to(device), 42, WalkConfig(4096, 0.1, 5), reps=10,
             plain_reps=1)
    k4_check("HMC driver, 20x20 grid", pack_laplacian(
        synthetic.generate("grid", 400, seed=0)["adjacency"]).to(device), 42,
        WalkConfig(500, 0.1, 5), reps=20, plain_reps=3)
    big = synthetic.generate("grid", 4096, seed=0)["adjacency"]
    k4_check("edge of the regime, 64x64 grid", pack_laplacian(big).to(device), 7,
             WalkConfig(8192, 0.1, 10), reps=10, plain_reps=1)
    k4_check("long walks, 64x64 grid", pack_laplacian(big).to(device), 7,
             WalkConfig(256, 0.1, 16), reps=10, plain_reps=1)
    del row["wrapper_ms"]
    return {"name": "walk_step_matrices", "route": "cuda",
            "source": "graphgp_tpu_torch/csrc/walker.cu",
            "replaces": "graphgp_tpu/pallas_kernels/walker.py:280",
            "launches": launches, **row, "library_ms": None}


# ---------------------------------------------------------------------------
# Phase 9: GRF-Thompson on the shipped facebook graph (CSR walks, ELL with
# its column-sorted transpose, ContractedFeatures; no kernel of this package)
# ---------------------------------------------------------------------------


def _fb_product_bounds(feats, b: int) -> tuple:
    """Byte bounds (ms) of the ELL forward and the transposed product at
    batch b: every array each reads once and its output written once. The
    forward reads the padded (L, N, R) cols and vals; the transposed product
    the used virtual rows' rows and vals and the (L, Nt + 1) pointers."""
    from graphgp_tpu_torch.features import CSC_BLOCK

    mats, csc = feats.mats, feats.csc
    l, n, r = mats.cols.shape
    nt = mats.num_target_nodes
    fwd = 4 * (2 * l * n * r + b * nt + b * n)
    tra = 8 * CSC_BLOCK * sum(csc.used_vrows) + 8 * csc.vrow_ptr.numel() + 4 * b * (n + nt)
    return bound_ms(fwd, 0.0)[0], bound_ms(tra, 0.0)[0]


def _fb_card_against_cpu(adj, device) -> None:
    """Walks over the first FB_CHECK_NODES start nodes, card against CPU (bit
    for bit); the same ELL's transpose built on the card against the CPU's
    (equal); its two products on the card against the CPU (float32 order)
    and against themselves (bit for bit)."""
    import torch

    from graphgp_tpu_torch import features as tfeat
    from graphgp_tpu_torch import graphs as tgraphs
    from graphgp_tpu_torch import walker as twalker

    cfg = twalker.WalkConfig(FB_CHECK_WPN, P_HALT, MAX_WALK_LENGTH)
    graph = tgraphs.pack_laplacian(adj)
    cpu = twalker.sample_walk_log(graph, DATA_SEED, cfg, num_start_nodes=FB_CHECK_NODES)
    card = twalker.sample_walk_log(graph.to(device), DATA_SEED, cfg, num_start_nodes=FB_CHECK_NODES)
    check(torch.equal(card.curs.cpu(), cpu.curs) and torch.equal(card.loads.cpu(), cpu.loads),
          "facebook: walks on the card differ from the CPU's")
    mats = tfeat.consolidate(cpu, tfeat.suggest_row_capacity(cpu), num_target_nodes=graph.num_nodes,
                             walks_per_node=FB_CHECK_WPN)
    host = tfeat.with_transpose(tfeat.EllFeatures(mats))
    on_card = tfeat.EllFeatures(mats.to(device), tfeat.transpose_ell(mats.to(device)))
    for name in ("rows", "vals", "seg_start", "last_pos", "has_any", "vrow_ptr"):
        check(torch.equal(getattr(on_card.csc, name).cpu(), getattr(host.csc, name)),
              f"facebook: the transpose's {name} built on the card differs from the CPU's")
    f = torch.tensor([1.0, 0.7, -0.4, 0.25, 0.1])
    gen = torch.Generator().manual_seed(0)
    errs = []
    for op, width in (("matvec_bm", host.num_target_nodes), ("rmatvec_bm", host.num_nodes)):
        for b in (1, FB_PROBES):
            v = torch.randn((b, width), generator=gen)
            first = getattr(on_card, op)(f.to(device), v.to(device))
            second = getattr(on_card, op)(f.to(device), v.to(device))
            check(torch.equal(first, second),
                  f"facebook: {op} at B={b} does not repeat on the card")
            _, rel = rel_err(first.cpu(), getattr(host, op)(f, v))
            errs.append(rel)
            check(rel <= REL_TOL_FB, f"facebook: {op} at B={b}, card against CPU {rel:.2e}")
    log(f"facebook card against CPU: walks of the first {FB_CHECK_NODES} start nodes at wpn "
        f"{FB_CHECK_WPN} bit-identical; transpose equal; products (B = 1, {FB_PROBES}) repeat bit "
        f"for bit, against the CPU max rel {max(errs):.2e} (tolerance {REL_TOL_FB:.0e}); "
        f"ELL R={mats.row_capacity}")


def facebook_path(device) -> None:
    import os

    import numpy as np
    import torch

    from graphgp_tpu_torch import features as tfeat
    from graphgp_tpu_torch import graphs as tgraphs
    from graphgp_tpu_torch import preprocessor
    from graphgp_tpu_torch.cli import bo as cli_bo
    from graphgp_tpu_torch.data.database import GraphDataLoader

    log(f"facebook BO: the JAX CPU record's settings (20 iterations, wpn 500, p_halt 0.1, L 5, "
        f"batch 1, 10 initial points, 30 epochs, retrain every 10, cg_tol 1e-2, gaussianized "
        f"targets, walk seed 42); depth cut: {FB_ITERATIONS} iterations, BO seeds {FB_SEEDS} "
        f"(the record: 20 iterations, seeds 100 and 110)")
    counts = {"forward": 0, "transposed": 0}
    originals = (preprocessor.preprocess_graph, cli_bo.make_algorithm,
                 tfeat.ell_phi_matvec_bm, tfeat.csc_phi_rmatvec_bm)
    trace: dict = {}
    captured: dict = {"algos": [], "per_iteration": []}

    def traced_preprocess(*args, **kwargs):
        captured["feats"] = originals[0](*args, trace=trace, **kwargs)
        return captured["feats"]

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    def make_algorithm(*args, **kwargs):
        algo = originals[1](*args, **kwargs)
        select = algo.select_next_points

        def counted_select(*a, **k):
            before = counts["forward"] + counts["transposed"]
            picked = select(*a, **k)
            captured["per_iteration"].append(counts["forward"] + counts["transposed"] - before)
            return picked

        algo.select_next_points = counted_select
        captured["algos"].append(algo)
        return algo

    with data_root() as tmp:
        try:
            data = GraphDataLoader(cache_dir="processed_data")("facebook")
            adj = data["adjacency"]
            graph = tgraphs.pack_laplacian(adj)
            log(f"facebook graph: N={adj.shape[0]}, nnz={adj.nnz}, largest degree "
                f"{int(np.diff(adj.indptr).max())}; walk layout {type(graph).__name__} "
                f"({graph.nnz} Laplacian entries)")
            check(isinstance(graph, tgraphs.CsrGraph), "facebook: the graph did not pack as CSR")
            t0 = time.perf_counter()
            _fb_card_against_cpu(adj, device)
            log(f"facebook card-against-CPU checks: {time.perf_counter() - t0:.2f} s")

            preprocessor.preprocess_graph = traced_preprocess
            cli_bo.make_algorithm = make_algorithm
            tfeat.ell_phi_matvec_bm = counted("forward", originals[2])
            tfeat.csc_phi_rmatvec_bm = counted("transposed", originals[3])
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            records = cli_bo.main([
                "--graph-type", "facebook", "--algorithms", "grf_thompson",
                "--iterations", str(FB_ITERATIONS), "--bo-seeds", *map(str, FB_SEEDS),
                "--walks-per-node", "500", "--p-halt", str(P_HALT),
                "--max-walk-length", str(MAX_WALK_LENGTH), "--batch-size", "1",
                "--initial-points", "10", "--train-epochs", "30", "--gp-retrain-interval", "10",
                "--cg-tol", "1e-2", "--gaussianize", "--seed", str(DATA_SEED),
                "--device", str(device), "--results-dir", os.path.join(tmp, "results"),
                "--cache-dir", os.path.join(tmp, "step_matrices"),
            ])
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
        finally:
            (preprocessor.preprocess_graph, cli_bo.make_algorithm,
             tfeat.ell_phi_matvec_bm, tfeat.csc_phi_rmatvec_bm) = originals

    check_no_error_rows("facebook BO", records)
    feats = captured["feats"]
    mats, csc = feats.mats, feats.csc
    check(isinstance(feats, tfeat.EllFeatures) and csc is not None,
          f"facebook: layout {type(feats).__name__} without the transpose")
    check(mats.cols.is_cuda and csc.rows.is_cuda, "facebook: the features are not on the card")
    ell_mb = (mats.cols.numel() * 4 + mats.vals.numel() * 4) / 1e6
    log(f"facebook layout: EllFeatures with the column-sorted transpose; L={mats.max_walk_length}, "
        f"R={mats.row_capacity}, live entries {int(mats.nnz())}; ELL {ell_mb:.1f} MB, transpose "
        f"{csc.nbytes() / 1e6:.1f} MB (used virtual rows {list(csc.used_vrows)})")
    log(f"facebook preprocessing: walk+consolidate {trace['walk_consolidate_s']:.3f} s, offset "
        f"scan {trace['vocabulary_s']:.3f} s, transpose {trace['transpose_s']:.3f} s (on the card)")
    per_iteration = captured["per_iteration"]
    for seed, algo in zip(FB_SEEDS, captured["algos"]):
        fits, draws = algo.phase_seconds["fit"], algo.phase_seconds["draw"]
        log(f"facebook seed {seed}: fit s {[round(x, 3) for x in fits]} ({len(fits)} fits of 30 "
            f"epochs), draw s {[round(x, 3) for x in draws]}")
    log(f"facebook products (forward + transposed) per BO iteration: {per_iteration}; in all "
        f"{counts}")
    log(f"facebook BO total: {total_s:.2f} s (with preprocessing and the drivers' I/O); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for seed in FB_SEEDS:
        regret = np.asarray([r["regret"] for r in records if r["seed"] == seed])
        log(f"facebook seed {seed}: regret {regret.round(4).tolist()}; final {regret[-1]:.4f} "
            f"(the JAX CPU record: {FB_REGRET_JAX_CPU})")
        check(regret.size == FB_ITERATIONS, f"facebook seed {seed}: {regret.size} records")
        check(bool(np.isfinite(regret).all()), f"facebook seed {seed}: regret not finite")
        check(bool(np.all(np.diff(regret) <= 0)), f"facebook seed {seed}: regret increased")
        check(regret[-1] <= regret[0], f"facebook seed {seed}: regret ended above its first")
    check(counts["forward"] > 0 and counts["transposed"] > 0,
          "facebook: the ELL products did not run on the main path")

    f = torch.tensor([1.0, 0.7, -0.4, 0.25, 0.1], device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    for b in (1, FB_PROBES):
        v_t = torch.randn((b, mats.num_target_nodes), device=device, generator=gen)
        v_s = torch.randn((b, mats.num_nodes), device=device, generator=gen)
        fwd_ms = cuda_ms(lambda: tfeat.ell_phi_matvec_bm(mats, f, v_t), reps=10)
        tra_ms = cuda_ms(lambda: tfeat.csc_phi_rmatvec_bm(csc, f, v_s), reps=10)
        fwd_bound, tra_bound = _fb_product_bounds(feats, b)
        same = (torch.equal(tfeat.ell_phi_matvec_bm(mats, f, v_t),
                            tfeat.ell_phi_matvec_bm(mats, f, v_t))
                and torch.equal(tfeat.csc_phi_rmatvec_bm(csc, f, v_s),
                                tfeat.csc_phi_rmatvec_bm(csc, f, v_s)))
        check(same, f"facebook: a product at B={b} does not repeat bit for bit")
        log(f"facebook products at B={b}: ELL forward {fwd_ms:.4f} ms (byte bound "
            f"{fwd_bound:.4f} ms), transposed through the transpose {tra_ms:.4f} ms (byte bound "
            f"{tra_bound:.4f} ms); repeat bit for bit")


# ---------------------------------------------------------------------------
# Phase 11: the orchestrator (cli.run_all over two synthetic graph types)
# ---------------------------------------------------------------------------


def orchestrator(device) -> None:
    """cli.run_all.main over circle and grid at 4096 nodes, random search and
    GRF-Thompson, one run of 3 iterations: no error row, the combined CSV
    written; the stencil kernels' counters zeroed just before and read just
    after."""
    import csv
    import os
    import tempfile

    import torch

    from graphgp_tpu_torch.cli import run_all
    from graphgp_tpu_torch.cuda_kernels import stencil as k1
    from graphgp_tpu_torch.cuda_kernels import stencil_build as k3

    log(f"orchestrator: cli.run_all over {' '.join(RUN_ALL_ARGV)}")
    k1.launches = k1.dw_launches = k3.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        records = run_all.main([*RUN_ALL_ARGV, "--device", device, "--results-dir", d,
                                "--cache-dir", os.path.join(d, "cache")])
        path = os.path.join(d, "bo_all_graphs.csv")
        check(os.path.exists(path), "orchestrator: bo_all_graphs.csv was not written")
        with open(path, newline="") as fh:
            rows = list(csv.DictReader(fh))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    check_no_error_rows("orchestrator", records)
    final = {(r["graph_type"], r["algorithm"]): r["regret"] for r in records if r["iteration"] == 3}
    log(f"orchestrator: {total_s:.2f} s; {len(rows)} rows in bo_all_graphs.csv; final regret "
        f"{ {k: round(v, 4) for k, v in final.items()} }; K1 launches {k1.launches}, dw "
        f"{k1.dw_launches}, K3 {k3.launches}; {card_line()}")
    check(len(rows) == len(records) == 2 * 2 * 3, f"orchestrator: {len(rows)} rows")
    check(k1.launches > 0 and k3.launches == 2, "orchestrator: GRF-Thompson did not run on K1/K3")



# ---------------------------------------------------------------------------
# Phase 12: Laplace-whitened HMC over the GP's hyperparameters (K4 once)
# ---------------------------------------------------------------------------


def hmc_card_against_cpu(device, steps) -> None:
    """The HMC driver's posterior as cli.hmc builds it (``build_problem`` on
    the CPU: ML-II fit, raw_noise anchored at its ML-II value, the mode
    refined by L-BFGS), card against CPU on the same step matrices: the log
    posterior and its gradient 0.1 off the mode (rel REL_TOL_HMC), the
    Hessian's clipped covariance at the mode (REL_TOL_HMC_HESSIAN), and
    HMC_CHECK_ITERS iterations of the sampler on the Laplace-whitened target
    at the step sizes the driver adapted on the card (``steps``, one a
    chain, jittered as the driver jitters them) under the same draws
    (REL_TOL_HMC_TRAJECTORY, every accept decision equal; a decision within
    HMC_MARGIN nats of its threshold, where float32 rounding could flip it,
    is reported)."""
    import torch

    from graphgp_tpu_torch.cli import hmc as hmc_cli
    from graphgp_tpu_torch.features import DenseFeatures
    from graphgp_tpu_torch.gp import hmc

    d = hmc_cli.build_parser().parse_args(HMC_ARGV)
    prob = hmc_cli.build_problem(d, "cpu")
    lp_cpu, params = prob.log_post, prob.mode
    lp_card = hmc_cli.gp_log_posterior(
        DenseFeatures(prob.feats.step_matrices.to(device)), prob.tr.to(device),
        prob.y[prob.tr].to(device), d.kind, d.prior_std, float(prob.fit.params["raw_noise"]))

    def value_and_grad(lp, dev):
        # off the mode, where the gradient is not ~0
        p = {k: (v + 0.1).to(dev).requires_grad_(True) for k, v in params.items()}
        val = lp(p)
        grads = torch.autograd.grad(val, list(p.values()))
        return val.detach().cpu(), torch.stack([g.cpu() for g in grads])

    (v_c, g_c), (v_g, g_g) = value_and_grad(lp_cpu, "cpu"), value_and_grad(lp_card, device)
    _, rel_v = rel_err(v_g, v_c)
    _, rel_g = rel_err(g_g, g_c)
    flat_c, sqrt_c, spec = hmc.laplace_whitening(lp_cpu, params)
    _, sqrt_g, _ = hmc.laplace_whitening(lp_card, {k: v.to(device) for k, v in params.items()})
    _, rel_h = rel_err((sqrt_g @ sqrt_g.T).cpu(), sqrt_c @ sqrt_c.T)

    cfg = hmc.HMCConfig(num_warmup=0, num_samples=HMC_CHECK_ITERS, num_leapfrog=d.num_leapfrog,
                        initial_step_size=1.0)
    draws = hmc.draw(HMC_CHAINS, HMC_CHECK_ITERS, flat_c.numel(), torch.Generator().manual_seed(0),
                     step_jitter=d.step_jitter)
    scale = torch.ones_like(draws.uniform) if draws.step_scale is None else draws.step_scale
    draws = draws._replace(step_scale=torch.as_tensor(steps, dtype=torch.float32)[:, None] * scale)

    def run(lp, dev):
        f0, s0 = flat_c.to(dev), sqrt_c.to(dev)
        return hmc.sample(lambda zp: lp(hmc._unflatten(f0 + s0 @ zp["z"], spec)),
                          {"z": torch.zeros(flat_c.numel(), device=dev)}, config=cfg,
                          num_chains=HMC_CHAINS, draws=draws)

    res_c, res_g = run(lp_cpu, "cpu"), run(lp_card, device)
    _, rel_z = rel_err(res_g.samples["z"].cpu(), res_c.samples["z"])
    _, rel_lp = rel_err(res_g.log_probs.cpu(), res_c.log_probs)
    log_u = torch.log(draws.uniform.double())
    log_a = torch.log(res_c.accept_trace.double())
    acc_c = log_u < log_a
    acc_g = log_u < torch.log(res_g.accept_trace.double().cpu())
    margin = (log_u - log_a).abs()
    close = [(int(c), int(t), float(margin[c, t])) for c, t in torch.nonzero(margin < HMC_MARGIN)]
    log(f"HMC card against CPU (the driver's posterior, built on the CPU: grid N {d.n_nodes}, "
        f"{prob.tr.numel()} train, {d.kind}, raw_noise anchored at "
        f"{float(prob.fit.params['raw_noise']):.4f}): log posterior rel {rel_v:.2e}, gradient rel "
        f"{rel_g:.2e}, Laplace covariance rel {rel_h:.2e}; {HMC_CHECK_ITERS} iterations x "
        f"{HMC_CHAINS} chains at the driver's adapted step sizes {[round(float(e), 4) for e in steps]}"
        f" (jitter {d.step_jitter}), {d.num_leapfrog} leapfrog steps: z rel {rel_z:.2e}, log probs "
        f"rel {rel_lp:.2e}, accept decisions equal {bool(torch.equal(acc_c, acc_g))} "
        f"({int(acc_c.sum())} accepts, {int((~acc_c).sum())} rejections; smallest margin "
        f"{float(margin.min()):.2e} nats; within {HMC_MARGIN} of the threshold (chain, iteration, "
        f"margin): {close})")
    check(rel_v <= REL_TOL_HMC and rel_g <= REL_TOL_HMC,
          f"HMC: log posterior rel {rel_v}, gradient rel {rel_g}")
    check(rel_h <= REL_TOL_HMC_HESSIAN, f"HMC: Laplace covariance rel {rel_h}")
    check(torch.equal(acc_c, acc_g), "HMC: accept decisions differ between card and CPU")
    check(float(acc_c.double().mean()) >= 0.5,
          f"HMC: only {float(acc_c.double().mean())} of the check's proposals accepted")
    check(rel_z <= REL_TOL_HMC_TRAJECTORY and rel_lp <= REL_TOL_HMC_TRAJECTORY,
          f"HMC: trajectory rel {rel_z}, log probs rel {rel_lp}")


def hmc_path(device):
    """cli.hmc.main at the JAX driver's defaults on the card: seconds by stage,
    batched gradient evaluations per second, K4 once, and the guards (split
    R-hat, adapted step sizes, accept rates, finite predictive metrics,
    beta's spread). Returns (K4 launches, the adapted step sizes)."""
    import tempfile

    import numpy as np
    import torch

    from graphgp_tpu_torch import kernels
    from graphgp_tpu_torch.cli import hmc as hmc_cli
    from graphgp_tpu_torch.cuda_kernels import walker as k4
    from graphgp_tpu_torch.gp import exact, hmc

    d = hmc_cli.build_parser().parse_args(HMC_ARGV)
    log(f"HMC: cli.hmc at the JAX driver's defaults (grid N {d.n_nodes}, walks {d.walks_per_node}, "
        f"p_halt {d.p_halt}, L {d.max_walk_length}, {d.kind}, {d.num_chains} chains, "
        f"{d.num_warmup} warmup + {d.num_samples} samples, {d.num_leapfrog} leapfrog steps, "
        f"eps0 {d.initial_step_size}, step jitter {d.step_jitter}); no depth cut")
    totals, _, restore = _timed_calls({
        "features": (kernels, "features_for_adjacency"), "ML-II fit": (exact, "fit"),
        "refine": (hmc, "refine_mode"), "sampling": (hmc, "sample_laplace"),
        "prediction": (hmc_cli, "posterior_average")})
    sampled = []
    timed_sample = hmc.sample_laplace
    hmc.sample_laplace = lambda *a, **kw: sampled.append(timed_sample(*a, **kw)) or sampled[-1]
    evals0 = hmc.gradient_evaluations
    k4.launches = 0
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as results_dir:
            records = hmc_cli.main([*HMC_ARGV, "--device", device, "--results-dir", results_dir])
    finally:
        hmc.sample_laplace = timed_sample
        restore()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = k4.launches
    evals = hmc.gradient_evaluations - evals0
    check_no_error_rows("HMC", records)
    by = {r["quantity"]: r["value"] for r in records}
    res = sampled[0]
    steps = res.step_size.cpu().numpy()
    acc = res.accept_rate.cpu().numpy()
    rhats = {k: v for k, v in by.items() if k.startswith("rhat_")}
    stages = ", ".join(f"{k} {v:.2f} s" for k, v in totals.items())
    log(f"HMC: {total_s:.2f} s in all ({stages}); {evals} batched gradient evaluations "
        f"({d.num_chains} chains each) in sampling, {evals / totals['sampling']:.1f} a second; "
        f"K4 launches {launches}; {card_line()}")
    log(f"HMC: point rmse / nlpd {by['point_rmse']:.4f} / {by['point_nlpd']:.4f}, posterior-"
        f"averaged {by['bayes_rmse']:.4f} / {by['bayes_nlpd']:.4f}; split R-hat "
        f"{ {k: round(v, 3) for k, v in rhats.items()} }; step sizes {np.round(steps, 4).tolist()}; "
        f"accept rates {np.round(acc, 3).tolist()}; beta {by['beta_mean']:.3f} +- {by['beta_std']:.3f}")
    check(launches == 1, f"HMC: {launches} K4 launches")
    check(all(v < HMC_RHAT_MAX for v in rhats.values()), f"HMC: split R-hat {rhats}")
    check(bool((steps > HMC_STEP_MIN).all()), f"HMC: adapted step sizes {steps}")
    check(bool((acc > HMC_ACCEPT_MIN).all()), f"HMC: accept rates {acc}")
    check(np.isfinite(by["bayes_rmse"]) and np.isfinite(by["bayes_nlpd"]),
          "HMC: posterior-averaged metrics not finite")
    check(by["beta_std"] > 0, "HMC: beta_std is 0")
    return launches, steps


# ---------------------------------------------------------------------------
# Phase 13: the multi-device path on one card (an NCCL group of world size 1)
# ---------------------------------------------------------------------------


def multi_device_path(device) -> None:
    """At the multichip CLI's defaults, on an NCCL group of world size 1 in
    this process: sharded_walk_log bit-identical to sample_walk_log, and
    distributed_gram_solve on LogFeatures against the single-device CG (50
    iterations at tol 0, two all-reduces a matvec); then cli.multichip.main
    with --devices 1 (one spawned rank): the card's walks/s and CG
    iterations/s, not a scaling measurement."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from graphgp_tpu_torch import shard
    from graphgp_tpu_torch.cli import multichip
    from graphgp_tpu_torch.data.synthetic import generate_ring_data
    from graphgp_tpu_torch.features import LogFeatures
    from graphgp_tpu_torch.gp import params as P
    from graphgp_tpu_torch.gp.iterative import make_ktt_matvec
    from graphgp_tpu_torch.graphs import pack_laplacian
    from graphgp_tpu_torch.linalg import batched_cg
    from graphgp_tpu_torch.walker import WalkConfig, sample_walk_log

    graph = pack_laplacian(generate_ring_data(MULTI_N, seed=0)["adjacency"]).to(device)
    cfg = WalkConfig(MULTI_WPN, 0.1, MULTI_L)
    with tempfile.TemporaryDirectory() as store:
        shard.init_process_group(0, 1, os.path.join(store, "store"), device)
        try:
            mesh = shard.make_mesh(1)
            t0 = time.perf_counter()
            walked = shard.sharded_walk_log(graph, 0, cfg, mesh)
            torch.cuda.synchronize()
            walk_s = time.perf_counter() - t0
            plain = sample_walk_log(graph, 0, cfg)
            same = torch.equal(walked.curs, plain.curs) and torch.equal(walked.loads, plain.loads)
            feats = LogFeatures(plain, num_target_nodes=MULTI_N)
            params = P.init_params("free", MULTI_L, generator=torch.Generator().manual_seed(1))
            rng = np.random.default_rng(0)
            idx = torch.from_numpy(np.sort(rng.choice(MULTI_N, MULTI_TRAIN, replace=False)))
            b = torch.from_numpy(rng.normal(size=(MULTI_TRAIN, MULTI_BATCH)).astype(np.float32))
            before = shard.all_reduces
            x = shard.distributed_gram_solve(feats, params, idx, b, mesh, tol=0.0,
                                             max_iters=MULTI_CG_ITERS)
            reduces = shard.all_reduces - before
        finally:
            dist.destroy_process_group()
    ref = batched_cg(make_ktt_matvec("free"), ({k: v.to(device) for k, v in params.items()},
                                                feats, idx.to(device)),
                     b.to(device), tol=0.0, max_iters=MULTI_CG_ITERS, batch_axis=1)
    _, rel = rel_err(x, ref.x)
    log(f"multi-device (NCCL, world 1): ring N {MULTI_N}, wpn {MULTI_WPN}, L {MULTI_L}: sharded "
        f"walk {walk_s:.3f} s, bit-identical to sample_walk_log {same}; distributed CG on "
        f"LogFeatures ({MULTI_TRAIN} train, B {MULTI_BATCH}, {MULTI_CG_ITERS} iterations at tol 0) "
        f"against single-device CG ({ref.iterations} iterations): rel {rel:.2e}, {reduces} "
        f"all-reduces")
    check(same, "multi-device: the sharded walk differs from sample_walk_log")
    check(rel <= REL_TOL_MULTI_CG, f"multi-device: distributed CG rel {rel}")
    # one matvec an iteration (none at the zero start), two all-reduces each
    check(reduces == 2 * MULTI_CG_ITERS, f"multi-device: {reduces} all-reduces")
    del walked, plain, feats
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as results_dir:
        records = multichip.main(["--devices", "1", "--device", device, "--results-dir", results_dir])
    check(len(records) == 1, f"multichip: {len(records)} records")
    r = records[0]
    check(np.isfinite(r["walks_per_s"]) and np.isfinite(r["cg_iters_per_s"]),
          "multichip: throughput not finite")
    log(f"multichip (1 rank, NCCL): {r['walks_per_s']:,.0f} walks/s ({r['walk_seconds']:.4f} s), "
        f"{r['cg_iters_per_s']:.1f} CG iterations/s ({r['cg_seconds']:.4f} s for "
        f"{MULTI_CG_ITERS}); one card's throughput, not a scaling measurement; {card_line()}")

# ---------------------------------------------------------------------------
# Phase 14: training and prediction with the features split over ranks, the
# ported dryrun, and the BO sweep's per-cell isolation
# ---------------------------------------------------------------------------


def sharded_training_path(device) -> None:
    """gp.iterative.fit (15 Adam steps) and pathwise_predict over
    shard.ShardedFeatures on an NCCL group of world size 1, at the multichip
    CLI's ring (N 32768, walks 100, L 3, LogFeatures), against the same calls
    on the whole features, with the same probes and ε: seconds an Adam step,
    the collectives a Gram matvec and an Adam step. Then the ported
    multi-chip dryrun in the same group. One card: not a scaling
    measurement."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from graphgp_tpu_torch import shard
    from graphgp_tpu_torch.cuda_kernels import gram as k2
    from graphgp_tpu_torch.cuda_kernels import stencil as k1
    from graphgp_tpu_torch.cuda_kernels import stencil_build as k3
    from graphgp_tpu_torch.cuda_kernels import walker as k4
    from graphgp_tpu_torch.data.synthetic import generate_ring_data
    from graphgp_tpu_torch.features import LogFeatures, contract
    from graphgp_tpu_torch.gp import iterative
    from graphgp_tpu_torch.gp import params as P
    from graphgp_tpu_torch.graphs import pack_laplacian
    from graphgp_tpu_torch.walker import WalkConfig, sample_walk_log

    def kernel_launches():
        return (k1.launches + k1.dw_launches + k2.rmv_mask_launches + k2.mv_epilogue_launches
                + k3.launches + k4.launches)

    launches_before = kernel_launches()
    data = generate_ring_data(MULTI_N, seed=0)
    graph = pack_laplacian(data["adjacency"]).to(device)
    feats = LogFeatures(sample_walk_log(graph, 0, WalkConfig(MULTI_WPN, 0.1, MULTI_L)), MULTI_N)
    train_idx = torch.arange(0, MULTI_N, SHARD_STRIDE, device=device)
    test_idx = torch.arange(SHARD_STRIDE // 2, MULTI_N, SHARD_STRIDE, device=device)
    y = torch.from_numpy(data["y_observed"].astype(np.float32)).to(device)[train_idx]
    gen = torch.Generator().manual_seed(7)
    probes = (torch.randint(0, 2, (SHARD_STEPS, SHARD_SETTINGS["num_probes"], MULTI_N),
                            generator=gen) * 2.0 - 1.0).to(device)
    eps1 = torch.randn((SHARD_SAMPLES, MULTI_N), generator=gen).to(device)
    eps2 = torch.randn((SHARD_SAMPLES, train_idx.numel()), generator=gen).to(device)
    settings = iterative.CGSettings(**SHARD_SETTINGS)
    init = P.init_params("diffusion", MULTI_L, device=device)

    def fit(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = iterative.fit(f, train_idx, y, kind="diffusion", init=init, num_steps=SHARD_STEPS,
                            settings=settings, probes=probes)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) / SHARD_STEPS

    def predict(f, params):
        return iterative.pathwise_predict(f, params, train_idx, y, test_idx, kind="diffusion",
                                          num_samples=SHARD_SAMPLES, settings=settings,
                                          full_space=True, eps1=eps1, eps2=eps2)

    iterative.fit(feats, train_idx, y, kind="diffusion", init=init, num_steps=1,
                  settings=settings, probes=probes)  # first calls' set-up, outside the times
    whole, whole_step_s = fit(feats)
    whole_samples = predict(feats, whole.params)
    with tempfile.TemporaryDirectory() as store:
        shard.init_process_group(0, 1, os.path.join(store, "store"), device)
        try:
            mesh = shard.make_mesh(1)
            split = shard.sharded_features(feats, mesh)
            before = (shard.all_reduces, shard.all_gathers)
            phi = contract(split, P.modulator("diffusion", init, MULTI_L))
            phi.matvec_bm(phi.rmatvec_bm(torch.ones(1, MULTI_N, device=device)))
            per_matvec = (shard.all_reduces - before[0], shard.all_gathers - before[1])
            before = (shard.all_reduces, shard.all_gathers)
            sharded, sharded_step_s = fit(split)
            per_step = ((shard.all_reduces - before[0]) / SHARD_STEPS,
                        (shard.all_gathers - before[1]) / SHARD_STEPS)
            samples = predict(split, whole.params)
            t0 = time.perf_counter()
            dry = shard.dryrun_multichip(mesh)
            dry_s = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    launches = kernel_launches() - launches_before
    _, rel_loss = rel_err(sharded.losses, whole.losses)
    param_err = max(float((sharded.params[k] - whole.params[k]).abs().max()) for k in init)
    _, rel_samples = rel_err(samples, whole_samples)
    log(f"sharded training (NCCL, world 1): ring N {MULTI_N}, wpn {MULTI_WPN}, L {MULTI_L}, "
        f"{train_idx.numel()} train, {SHARD_STEPS} Adam steps, "
        f"{iterative.CGSettings(**SHARD_SETTINGS)}: {sharded_step_s:.4f} s an Adam step "
        f"({whole_step_s:.4f} s unsharded); losses {sharded.losses[0].item():.4f} -> "
        f"{sharded.losses[-1].item():.4f}, rel {rel_loss:.2e} against unsharded, parameters "
        f"{param_err:.2e} abs; {SHARD_SAMPLES} pathwise samples at {test_idx.numel()} nodes rel "
        f"{rel_samples:.2e}; a Gram matvec {per_matvec[0]} all-reduce(s) and {per_matvec[1]} "
        f"all-gather(s), an Adam step {per_step[0]:.1f} and {per_step[1]:.1f}; kernel launches "
        f"{launches} (the walk log's products are PyTorch gathers and scatter-adds, as the JAX "
        f"package's are XLA's); one card, not a scaling measurement; {card_line()}")
    log(f"dryrun_multichip (NCCL, world 1): loss {dry['loss']:.4f}, solve norm "
        f"{dry['solve_norm']:.4f}, HMC accept {dry['hmc_accept']:.2f}, {dry_s:.2f} s")
    check(bool(torch.isfinite(sharded.losses).all()), "sharded training: loss not finite")
    check(sharded.losses[-1] < sharded.losses[0], "sharded training: the loss did not fall")
    check(rel_loss <= REL_TOL_SHARD_LOSS, f"sharded training: losses rel {rel_loss}")
    check(param_err <= ABS_TOL_SHARD_PARAMS, f"sharded training: parameters {param_err}")
    check(samples.shape == (SHARD_SAMPLES, test_idx.numel()), "sharded training: sample shape")
    check(rel_samples <= REL_TOL_SHARD_SAMPLES, f"sharded training: samples rel {rel_samples}")
    check(per_matvec == (1, 1), f"sharded training: a Gram matvec made {per_matvec} collectives")
    check(all(math.isfinite(v) for v in dry.values()), f"dryrun_multichip: {dry}")


def isolated_bo_sweep(device) -> None:
    """cli.bo --isolate on a small grid: random search and GRF-Thompson, one
    child process a cell, no error row; then one cell whose --cell-timeout is
    shorter than a child's start, run twice and killed twice: exactly one
    error row, naming the timeout."""
    import os
    import tempfile

    from graphgp_tpu_torch.cli import bo

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        cache = ["--cache-dir", os.path.join(d, "cache"), "--device", device]
        two = bo.main([*ISOLATE_ARGV, *cache, "--algorithms", "random_search", "grf_thompson",
                       "--results-dir", os.path.join(d, "two")])
        two_s = time.perf_counter() - t0
        short = bo.main([*ISOLATE_ARGV, *cache, "--algorithms", "grf_thompson",
                         "--cell-timeout", str(ISOLATE_SHORT_TIMEOUT),
                         "--results-dir", os.path.join(d, "short")])
    check_no_error_rows("isolated BO sweep", two)
    check(len(two) == 2 * 3, f"isolated BO sweep: {len(two)} rows")
    check(len(short) == 1 and "cell rc=timeout" in short[0].get("error", ""),
          f"isolated BO sweep: the timed-out cell gave {short}")
    final = {r["algorithm"]: r["regret"] for r in two if r["iteration"] == 3}
    log(f"isolated BO sweep: 2 cells {two_s:.2f} s, final regret "
        f"{ {k: round(v, 4) for k, v in final.items()} }; the {ISOLATE_SHORT_TIMEOUT} s cell: "
        f"one error row ({short[0]['error'].splitlines()[0]}), "
        f"{time.perf_counter() - t0 - two_s:.2f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    from graphgp_tpu_torch.cuda_kernels import _build  # fails outside a checkout

    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda:0"
    torch.cuda.set_device(0)

    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s)")
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", _build.build_log)]
    spills = [int(x) for pair in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                            _build.build_log) for x in pair]
    if regs:
        log(f"  ptxas: {len(regs)} kernel instances, {min(regs)}-{max(regs)} registers, "
            f"largest spill {max(spills, default=0)} bytes")
    per_kernel = ptxas_by_kernel(_build.build_log)
    for kernel in ("stencil_matvec_kernel", "stencil_dw_kernel", "gram_rmv_mask_kernel",
                   "gram_mv_epilogue_kernel"):
        for b in (1, 8, 16):
            hit = [v for k, v in per_kernel.items() if f"{kernel}ILi{b}EE" in k]
            if hit:
                log(f"  ptxas {kernel}<{b}>: {hit[0][0]} registers, spill stores {hit[0][1]} B, "
                    f"spill loads {hit[0][2]} B")
    for kernel, flag, what in (("ell_to_stencil_kernel", "ILb0EE", "4-byte copies"),
                               ("ell_to_stencil_kernel", "ILb1EE", "bulk copies"),
                               ("ell_to_stencil_rows_kernel", "", "narrow rows"),
                               ("walk_step_matrices_kernel", "ILb0EE", "principled"),
                               ("walk_step_matrices_kernel", "ILb1EE", "ablation"),
                               ("pack_walk_table_kernel", "", "")):
        hit = [v for k, v in per_kernel.items() if kernel in k and flag in k]
        if hit:
            log(f"  ptxas {kernel}{f'<{what}>' if what else ''}: {hit[0][0]} registers, spill "
                f"stores {hit[0][1]} B, spill loads {hit[0][2]} B")

    t0 = time.perf_counter()
    small_agreement(device)
    small_agreement_full_space(device)
    log(f"small-input agreement: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    flag = flagship(device)
    log(f"flagship main path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    fit_profile(device, flag)
    log(f"fit profile: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    scal = scaling_path(device)
    log(f"scaling path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cg_bench(device, flag)
    log(f"CG bench: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    k1_row, dw_row = k1_checks(device, flag, scal["launches"]["stencil_dw"])
    k3_row = k3_check(device, flag)
    k2a_row, k2b_row = k2_checks(device, flag, scal)
    log(f"kernel checks and timings: {time.perf_counter() - t0:.2f} s")
    del flag, scal  # the flagship's and the scaling path's tensors
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dense_small_agreement(device)
    log(f"dense small-input agreement: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    k4_launches = ablation_protocol(device)
    log(f"ablation protocol: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    k4_launches += traffic_protocol(device)
    log(f"traffic protocol: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    k4_launches += traffic_dataset_path(device)
    log(f"traffic protocol on the PEMS-BAY dataset with the GCN: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    k4_launches += wind_path(device)
    log(f"wind path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    svgp_card_against_cpu(device)
    k4_launches += classification_path(device)
    log(f"classification path: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k4_row = k4_checks(device, k4_launches)
    log(f"K4 checks and timings: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    facebook_path(device)
    log(f"facebook path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    orchestrator(device)
    log(f"orchestrator: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, steps = hmc_path(device)
    k4_row["launches"] += launches
    hmc_card_against_cpu(device, steps)
    log(f"HMC path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    multi_device_path(device)
    log(f"multi-device path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sharded_training_path(device)
    isolated_bo_sweep(device)
    log(f"sharded training and the isolated sweep: {time.perf_counter() - t0:.2f} s")
    rows = [k1_row, k3_row, k2a_row, k2b_row, k4_row, dw_row]

    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
