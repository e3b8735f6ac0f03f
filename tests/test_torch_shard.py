"""``shard.py``, ``LogFeatures`` and ``cli/multichip`` against
``graphgp_tpu/shard.py`` and ``graphgp_tpu/features.py`` on the CPU.

The ranks are processes started by ``shard.run_ranks``: gloo, a file-store
rendezvous in a temporary directory (no port), one torch thread each. Each
rank imports this module to find its function, so JAX is imported inside
the tests only. One run of ranks for each world size does all of that size's
work (a module fixture); the tests read its results.

The JAX references run on the conftest's 8-device virtual CPU mesh.
Tolerances: walks and sharded walks bit for bit; the distributed solve to
rel 1e-4 of the largest reference entry at CG tol 1e-8 (float32 sums in
another order, all-reduced); the walk-log products to 1e-5 of the largest
reference entry (einsum and scatter-add orders; on CUDA the scatter adds by
atomics in no fixed order, so repeats there agree to that, not bit for bit).
The sharded HMC chains are held to the JAX test's moments, R̂ and accept
bounds: they follow the same draws with and without ranks.
"""
import numpy as np
import pytest
import torch

from graphgp_tpu_torch import convert, shard
from graphgp_tpu_torch.gp import hmc
from graphgp_tpu_torch.graphs import pack_laplacian
from graphgp_tpu_torch.walker import WalkConfig, sample_walk_log

WALK_N, WALK_CFG, WALK_SEED = 52, dict(walks_per_node=4, p_halt=0.2, max_walk_length=3), 3
SOLVE_N = 64
PREC = np.asarray([[2.0, 0.5, 0.0], [0.5, 1.5, 0.3], [0.0, 0.3, 1.0]], np.float32)
HMC_CFG = dict(num_warmup=200, num_samples=600, num_leapfrog=8)
HMC_SHORT = dict(num_warmup=8, num_samples=8, num_leapfrog=6, initial_step_size=0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ring(n):
    adj = np.zeros((n, n))
    idx = np.arange(n)
    adj[idx, (idx + 1) % n] = 1.0
    adj[(idx + 1) % n, idx] = 1.0
    return adj


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _gaussian_log_prob(p):
    return -0.5 * p["x"] @ torch.from_numpy(PREC) @ p["x"]


# ---------------------------------------------------------------------------
# What the ranks run (module-level: each rank imports it by name)
# ---------------------------------------------------------------------------


def _rank_work(mesh, solve_inputs, with_hmc):
    out = {"rank": mesh.rank, "size": mesh.size}
    graph = pack_laplacian(_ring(WALK_N))
    out["walk"] = tuple(t.clone() for t in shard.sharded_walk_log(
        graph, WALK_SEED, WalkConfig(**WALK_CFG), mesh))
    out["walk_own_rows"] = shard.sharded_walk_log(
        graph, WALK_SEED, WalkConfig(**WALK_CFG), mesh, gather=False).curs.shape[1]
    for name, (curs, loads, nt, params, train_idx, b) in solve_inputs.items():
        feats = convert.log_features_from_jax(curs, loads, nt)
        params = convert.params_from_jax(params)
        x = shard.distributed_gram_solve(feats, params, torch.from_numpy(train_idx),
                                         torch.from_numpy(b), mesh, kind="diffusion",
                                         tol=1e-8, max_iters=300)
        out[f"solve_{name}"] = x
        if name == "batch":
            before = shard.all_reduces
            shard.distributed_gram_solve(feats, params, torch.from_numpy(train_idx),
                                         torch.from_numpy(b), mesh, kind="diffusion",
                                         tol=0.0, max_iters=20)
            out["all_reduces_20_iterations"] = shard.all_reduces - before
    if with_hmc:
        res = hmc.sample(_gaussian_log_prob, {"x": torch.zeros(3)},
                         torch.Generator().manual_seed(0), config=hmc.HMCConfig(**HMC_CFG),
                         num_chains=10, mesh=shard.make_mesh(mesh.size, axis_name="chains"))
        out["hmc"] = res
        out["chains"] = shard.sharded_hmc_chains(mesh, 10)
        out["hmc_short"] = hmc.sample(
            _gaussian_log_prob, {"x": torch.zeros(3)}, torch.Generator().manual_seed(1),
            config=hmc.HMCConfig(**HMC_SHORT), num_chains=3, mesh=mesh)
    return out


@pytest.fixture(scope="module")
def solve_inputs():
    """Both solves' inputs from the JAX package (its walk logs, its
    diffusion parameters at noise 0.3), with JAX's single-device reference
    and its 8-device distributed solve."""
    import jax
    import jax.numpy as jnp

    from graphgp_tpu import WalkConfig as JWalkConfig
    from graphgp_tpu import pack_laplacian as jpack
    from graphgp_tpu.features import LogFeatures as JLogFeatures
    from graphgp_tpu.gp import params as JP
    from graphgp_tpu.shard import distributed_gram_solve, make_mesh
    from graphgp_tpu.walker import sample_walk_log as jwalk

    inputs, refs = {}, {}
    for name, n, wpn, seed, rhs in (("batch", SOLVE_N, 30, 0, 3), ("padded", 61, 20, 4, 0)):
        log = jwalk(jpack(_ring(n)), jax.random.PRNGKey(seed),
                    JWalkConfig(walks_per_node=wpn, p_halt=0.1, max_walk_length=3))
        params = {k: np.asarray(v) for k, v in
                  JP.init_params("diffusion", 3, jax.random.PRNGKey(1), noise=0.3).items()}
        train_idx = (np.arange(0, n, 2) if name == "batch" else np.arange(1, n, 3)).astype(np.int32)
        rng = np.random.default_rng(seed)
        shape = (train_idx.shape[0], rhs) if rhs else train_idx.shape[0]
        b = rng.normal(size=shape).astype(np.float32)
        inputs[name] = (np.asarray(log.curs), np.asarray(log.loads), n, params, train_idx, b)
        refs[name] = np.asarray(distributed_gram_solve(
            JLogFeatures(log, num_target_nodes=n), {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(train_idx), jnp.asarray(b), make_mesh(8), kind="diffusion",
            tol=1e-8, max_iters=300))
    return inputs, refs


@pytest.fixture(scope="module")
def ranks(solve_inputs):
    inputs, _ = solve_inputs
    return {
        2: shard.run_ranks(_rank_work, 2, inputs, True, device="cpu"),
        3: shard.run_ranks(_rank_work, 3, {}, False, device="cpu"),
        4: shard.run_ranks(_rank_work, 4, inputs, False, device="cpu"),
    }


@pytest.fixture(scope="module")
def jax_walk():
    import jax

    from graphgp_tpu import WalkConfig as JWalkConfig
    from graphgp_tpu import pack_laplacian as jpack
    from graphgp_tpu.walker import sample_walk_log as jwalk

    log = jwalk(jpack(_ring(WALK_N)), jax.random.PRNGKey(WALK_SEED), JWalkConfig(**WALK_CFG))
    return np.asarray(log.curs), np.asarray(log.loads)


# ---------------------------------------------------------------------------
# Sharded walks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3, 4])
def test_sharded_walk_bit_identical_to_jax(ranks, jax_walk, world):
    """Every rank's gathered log equals JAX's single-device sample_walk_log
    bit for bit; at world 3 the tail block (16 of 18 rows) walks only its
    real rows."""
    curs, loads = jax_walk
    own = []
    for out in ranks[world]:
        assert out["size"] == world
        np.testing.assert_array_equal(out["walk"][0].numpy(), curs)
        np.testing.assert_array_equal(out["walk"][1].numpy(), loads)
        own.append(out["walk_own_rows"])
    block = -(-WALK_N // world)
    assert own == [min(block, WALK_N - r * block) for r in range(world)]


def test_sharded_walk_in_one_process_equals_the_plain_walk():
    """World size 1 in this process (gloo, a file store): the same log as
    sample_walk_log, and make_mesh's guards."""
    import os
    import tempfile

    import torch.distributed as dist

    graph = pack_laplacian(_ring(WALK_N))
    with pytest.raises(RuntimeError, match="no process group"):
        shard.make_mesh()
    with tempfile.TemporaryDirectory() as d:
        shard.init_process_group(0, 1, os.path.join(d, "store"), "cpu")
        try:
            mesh = shard.make_mesh(1)
            with pytest.raises(ValueError, match="needs 2 ranks"):
                shard.make_mesh(2)
            got = shard.sharded_walk_log(graph, WALK_SEED, WalkConfig(**WALK_CFG), mesh)
        finally:
            dist.destroy_process_group()
    ref = sample_walk_log(graph, WALK_SEED, WalkConfig(**WALK_CFG))
    assert torch.equal(got.curs, ref.curs) and torch.equal(got.loads, ref.loads)


@pytest.mark.parametrize("launcher", ["run_ranks", "init_process_group"])
def test_launchers_default_to_the_card(launcher, monkeypatch, tmp_path):
    """Without a card, both launchers raise at their default device (no rank
    is started, no group joined): only device="cpu" runs on the host."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if launcher == "run_ranks":
            shard.run_ranks(_rank_work, 1, {}, False)
        else:
            shard.init_process_group(0, 1, str(tmp_path / "store"))
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The distributed Gram solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["batch", "padded"])
def test_distributed_gram_solve_matches_jax(ranks, solve_inputs, world, name):
    """(K_tt + σ²I) x = b with the features split over the ranks, against
    JAX's distributed solve on its 8-device mesh; 61 nodes pad to a multiple
    of the world size (exact: zero rows), and a 1-D b stays 1-D."""
    _, refs = solve_inputs
    for out in ranks[world]:
        got = out[f"solve_{name}"].numpy()
        assert got.shape == refs[name].shape
        assert _rel(got, refs[name]) <= 1e-4


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_gram_solve_two_all_reduces_per_matvec(ranks, world):
    """tol 0, 20 iterations (of a 32-row system, so none reaches a zero
    residual and stops): 20 matvecs (one an iteration; none at the solve's
    zero start), two all-reduces each."""
    for out in ranks[world]:
        assert out["all_reduces_20_iterations"] == 2 * 20


def test_distributed_gram_solve_matches_single_device_cg(solve_inputs):
    """World size 1 in this process against the port's single-device CG on
    the uncontracted Gram matvec."""
    import os
    import tempfile

    import torch.distributed as dist

    from graphgp_tpu_torch.gp.iterative import make_ktt_matvec
    from graphgp_tpu_torch.linalg import batched_cg

    curs, loads, n, params, train_idx, b = solve_inputs[0]["batch"]
    feats = convert.log_features_from_jax(curs, loads, n)
    p = convert.params_from_jax(params)
    idx = torch.from_numpy(train_idx.astype(np.int64))
    ref = batched_cg(make_ktt_matvec("diffusion"), (p, feats, idx), torch.from_numpy(b),
                     tol=0.0, max_iters=50, batch_axis=1).x
    with tempfile.TemporaryDirectory() as d:
        shard.init_process_group(0, 1, os.path.join(d, "store"), "cpu")
        try:
            got = shard.distributed_gram_solve(feats, p, idx, torch.from_numpy(b),
                                               shard.make_mesh(1), kind="diffusion",
                                               tol=0.0, max_iters=50)
        finally:
            dist.destroy_process_group()
    assert _rel(got.numpy(), ref.numpy()) <= 1e-4


# ---------------------------------------------------------------------------
# Features over the node axis
# ---------------------------------------------------------------------------


def test_shard_pad_and_replicate_features():
    """Row blocks of Dense / ELL / Log features, zero padding that changes no
    product, and replication to the mesh's device."""
    from graphgp_tpu_torch.features import (
        DenseFeatures, EllFeatures, LogFeatures, consolidate, ell_to_dense)

    log = sample_walk_log(pack_laplacian(_ring(10)), 0, WalkConfig(8, 0.1, 3))
    ell = consolidate(log, 8)
    feats = {"dense": DenseFeatures(ell_to_dense(ell)), "ell": EllFeatures(ell),
             "log": LogFeatures(log, 10)}
    f = torch.tensor([1.0, -0.5, 0.25])
    v = torch.randn(10, generator=torch.Generator().manual_seed(0))
    for name, ft in feats.items():
        padded = shard.pad_features(ft, 12)
        assert padded.num_nodes == 12
        torch.testing.assert_close(padded.rmatvec(f, torch.cat([v, torch.ones(2)])),
                                   ft.rmatvec(f, v), rtol=1e-6, atol=1e-6)
        whole = padded.matvec(f, v)
        rows = [shard.shard_features(padded, shard.Mesh(None, r, 3, torch.device("cpu")))
                for r in range(3)]
        torch.testing.assert_close(torch.cat([blk.matvec(f, v) for blk in rows]), whole,
                                   rtol=1e-6, atol=1e-6)
        with pytest.raises(ValueError, match="pad_features"):
            shard.shard_features(ft, shard.Mesh(None, 0, 3, torch.device("cpu")))
    mesh = shard.Mesh(None, 0, 1, torch.device("cpu"))
    rep = shard.replicate({"log": log, "params": [torch.ones(2)], "n": 3}, mesh)
    assert torch.equal(rep["log"].curs, log.curs) and rep["n"] == 3


def test_log_features_products_match_jax():
    """The five walk-log products against JAX's log_phi_* (the walks
    bit-identical, the sums to 1e-5)."""
    import jax
    import jax.numpy as jnp

    from graphgp_tpu import WalkConfig as JWalkConfig
    from graphgp_tpu import pack_laplacian as jpack
    from graphgp_tpu.features import LogFeatures as JLogFeatures
    from graphgp_tpu.walker import sample_walk_log as jwalk

    n, nt = 40, 40
    jlog = jwalk(jpack(_ring(n)), jax.random.PRNGKey(5), JWalkConfig(16, 0.1, 4))
    jf = JLogFeatures(jlog, num_target_nodes=nt)
    tf = convert.log_features_from_jax(np.asarray(jlog.curs), np.asarray(jlog.loads), nt)
    tlog = sample_walk_log(pack_laplacian(_ring(n)), 5, WalkConfig(16, 0.1, 4))
    assert torch.equal(tlog.curs, tf.log.curs) and torch.equal(tlog.loads, tf.log.loads)
    rng = np.random.default_rng(0)
    f = rng.normal(size=4).astype(np.float32)
    v1 = rng.normal(size=nt).astype(np.float32)
    vb = rng.normal(size=(nt, 3)).astype(np.float32)
    vr = np.ascontiguousarray(vb.T)
    rows = np.asarray([0, 7, 7, 39], np.int32)
    cases = {
        "matvec": (jf.matvec(f, jnp.asarray(vb)), tf.matvec(f, torch.from_numpy(vb))),
        "matvec_1d": (jf.matvec(f, jnp.asarray(v1)), tf.matvec(f, torch.from_numpy(v1))),
        "rmatvec": (jf.rmatvec(f, jnp.asarray(vb)), tf.rmatvec(f, torch.from_numpy(vb))),
        "rmatvec_1d": (jf.rmatvec(f, jnp.asarray(v1)), tf.rmatvec(f, torch.from_numpy(v1))),
        "matvec_bm": (jf.matvec_bm(f, jnp.asarray(vr)), tf.matvec_bm(f, torch.from_numpy(vr))),
        "rmatvec_bm": (jf.rmatvec_bm(f, jnp.asarray(vr)), tf.rmatvec_bm(f, torch.from_numpy(vr))),
        "rows": (jf.rows(f, jnp.asarray(rows)), tf.rows(f, torch.from_numpy(rows))),
    }
    for name, (ref, got) in cases.items():
        assert got.shape == tuple(ref.shape), name
        assert _rel(got.numpy(), ref) <= 1e-5, name


# ---------------------------------------------------------------------------
# HMC chains over ranks, and the multichip harness
# ---------------------------------------------------------------------------


def test_hmc_chains_sharded_over_ranks(ranks):
    """10 chains on 2 ranks (5 each): the JAX sharded-chains test's moments,
    R̂ and accept bounds; every rank holds all 10 chains, the same ones, and
    they equal the single-process run under the same generator seed."""
    outs = ranks[2]
    assert [o["chains"] for o in outs] == [slice(0, 5), slice(5, 10)]
    res = outs[0]["hmc"]
    assert res.samples["x"].shape == (10, HMC_CFG["num_samples"], 3)
    torch.testing.assert_close(outs[1]["hmc"].samples["x"], res.samples["x"], rtol=0, atol=0)
    draws = res.samples["x"].reshape(-1, 3).numpy()
    np.testing.assert_allclose(draws.mean(0), np.zeros(3), atol=0.12)
    np.testing.assert_allclose(np.cov(draws.T), np.linalg.inv(PREC), atol=0.15)
    rhat = hmc.split_rhat_tree(res.samples)["x"].numpy()
    assert rhat.shape == (3,) and np.all(rhat < 1.1), rhat
    assert np.all(res.accept_rate.numpy() > 0.5)
    assert np.isfinite(res.log_probs.numpy()).all()
    # 3 chains on 2 ranks (padded to 4, one dropped) follow the same draws as
    # a single-process run from the same seed: the same trajectories
    short = outs[0]["hmc_short"]
    alone = hmc.sample(_gaussian_log_prob, {"x": torch.zeros(3)}, torch.Generator().manual_seed(1),
                       config=hmc.HMCConfig(**HMC_SHORT), num_chains=4)
    assert short.samples["x"].shape == (3, HMC_SHORT["num_samples"], 3)
    assert _rel(short.samples["x"].numpy(), alone.samples["x"][:3].numpy()) <= 1e-4
    assert _rel(short.eps_trace.numpy(), alone.eps_trace[:3].numpy()) <= 1e-4


def test_multichip_cli_on_gloo_ranks(tmp_path):
    from graphgp_tpu_torch.cli.multichip import main

    records = main(["--device", "cpu", "--devices", "1", "2", "--n-nodes", "512",
                    "--n-train", "256", "--walks-per-node", "20", "--cg-iters", "10",
                    "--results-dir", str(tmp_path)])
    assert [r["n_devices"] for r in records] == [1, 2]
    for r in records:
        assert r["platform"] == "cpu" and r["n_nodes"] == 512
        assert np.isfinite(r["walks_per_s"]) and r["walks_per_s"] > 0
        assert np.isfinite(r["cg_iters_per_s"]) and r["cg_iters_per_s"] > 0
    assert records[0]["walk_parallel_efficiency"] == 1.0
    assert records[0]["cg_parallel_efficiency"] == 1.0
    assert (tmp_path / "multichip.csv").exists()
    # counts above the CPU's 8 are dropped, as the JAX CLI's virtual platform does
    assert main(["--device", "cpu", "--devices", "16", "--results-dir", str(tmp_path)]) == []


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_nccl_world_of_one_on_the_card():
    """A world-size-1 NCCL group on the card: the sharded walk equals the
    plain walk bit for bit, and the solve the CPU's to rel 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = shard.run_ranks(_card_work, 1, device="cuda")[0]
    graph = pack_laplacian(_ring(WALK_N))
    ref = sample_walk_log(graph, WALK_SEED, WalkConfig(**WALK_CFG))
    assert torch.equal(out["walk"][0], ref.curs) and torch.equal(out["walk"][1], ref.loads)
    assert _rel(out["solve"].numpy(), out["solve_cpu"].numpy()) <= 1e-4


def _card_work(mesh):
    from graphgp_tpu_torch.features import LogFeatures
    from graphgp_tpu_torch.gp import params as P

    graph = pack_laplacian(_ring(WALK_N))
    walk = shard.sharded_walk_log(graph, WALK_SEED, WalkConfig(**WALK_CFG), mesh)
    feats = LogFeatures(sample_walk_log(graph, 0, WalkConfig(30, 0.1, 3)), WALK_N)
    params = P.init_params("diffusion", 3, noise=0.3)
    idx = torch.arange(0, WALK_N, 2)
    b = torch.randn(idx.shape[0], 3, generator=torch.Generator().manual_seed(0))
    solve = shard.distributed_gram_solve(feats, params, idx, b, mesh, kind="diffusion",
                                         tol=1e-8, max_iters=300)
    from graphgp_tpu_torch.gp.iterative import make_ktt_matvec
    from graphgp_tpu_torch.linalg import batched_cg

    cpu = batched_cg(make_ktt_matvec("diffusion"), (params, feats, idx), b, tol=1e-8,
                     max_iters=300, batch_axis=1).x
    return {"walk": tuple(t.cpu() for t in walk), "solve": solve.cpu(), "solve_cpu": cpu}
