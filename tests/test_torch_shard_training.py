"""GP training and prediction with the features split over ranks
(``shard.ShardedFeatures``): ``mll_cg``, ``fit`` and ``pathwise_predict``
over ``torch.distributed``, and the ported multi-chip dryrun, against the
port's single-process results and the JAX package's on its 8-device mesh.

The ranks are processes started by ``shard.run_ranks`` (gloo, a file store
in a temporary directory, one torch thread each); one run of ranks a world
size does all of that size's work (a module fixture) under a timeout, so a
rank that takes another branch and waits in a collective fails the run
instead of hanging it. Each rank imports this module to find its function,
so JAX is imported inside the tests only. Inputs are the JAX package's (its
walk logs, ELL and dense step matrices, diffusion parameters, probes and ε
draws), handed over as numpy arrays.

Tolerances:
* ``mll_cg`` and its gradient for every parameter, all layouts and both
  solver spaces, CG at tol 1e-6 (both packages' solves converge fully):
  rel 1e-4 against the port in one process and against JAX. A gradient
  counted ``world`` times, or missing the other ranks' share, is off by
  a factor of 2 or more.
* ``fit``, 15 Adam steps at lr 0.1 with the JAX test's CG tol 1e-3: every
  loss rel 1e-3 and every final parameter 1e-2 absolute against JAX (the
  solves stop at tol 1e-3 in float32 sums of another order, and Adam's
  normalised steps carry that over 15 steps); against the port in one
  process, whose solves see the same operator summed in another order,
  rel 1e-4 and 1e-3.
* ``pathwise_predict`` under the same ε at tol 1e-6: rel 1e-4.
* 62 nodes over 4 ranks (zero rows pad to 64): loss and gradients rel 1e-4
  of the port in one process (JAX's mesh of 8 takes no 62-row split).
* ``rows``: equal to the whole features' (each row from one rank, zeros
  from the others).
* The dryrun: the JAX function prints 4 decimals; the loss agrees to 1e-4
  relative beside that rounding and the solve's norm (CG at tol 1e-3) to
  1e-3.
"""
import numpy as np
import pytest
import torch

from graphgp_tpu_torch import convert, shard
from graphgp_tpu_torch.features import with_transpose
from graphgp_tpu_torch.gp import iterative as tit

N, N_PAD, L = 64, 62, 3
WPN, P_HALT, R = 20, 0.1, 16
SETTINGS = dict(cg_tol=1e-6, cg_max_iters=200, num_probes=4)
FIT_N, FIT_L, FIT_WPN, FIT_STEPS = 128, 4, 50, 15
FIT_SETTINGS = dict(cg_tol=1e-3, cg_max_iters=50, num_probes=4)
SAMPLES = 4
LAYOUTS = ("log", "dense", "ell")
SPACES = ("compact", "full")
RANK_TIMEOUT = 300.0
ROWS_IDX, ROWS_F = torch.tensor([0, 5, 31, 32, 63, 5]), torch.tensor([1.0, -0.5, 0.25])


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


def _train_idx(n, space):
    return np.arange(0, n, 2 if space == "full" else 3).astype(np.int32)


def _port_features(arrays, layout):
    """The port's features from the JAX package's arrays; the ELL carries
    its column-sorted transpose, as the port builds it."""
    if layout == "log":
        return convert.log_features_from_jax(arrays["curs"], arrays["loads"], arrays["n"])
    if layout == "dense":
        return convert.dense_from_numpy(arrays["dense"])
    return with_transpose(convert.ell_features_from_jax(arrays["cols"], arrays["vals"],
                                                        arrays["n"]))


# ---------------------------------------------------------------------------
# The port's side: the same code for one process and for every rank
# ---------------------------------------------------------------------------


def _mll_and_grads(feats, case):
    params = {k: torch.tensor(v, requires_grad=True) for k, v in case["params"].items()}
    mll = tit.mll_cg(feats, params, torch.from_numpy(case["idx"]), torch.from_numpy(case["y"]),
                     kind="diffusion", settings=tit.CGSettings(**SETTINGS),
                     full_space=case["full"], probes=torch.from_numpy(case["probes"]))
    mll.backward()
    return float(mll.detach()), {k: v.grad.clone() for k, v in params.items()}


def _fit(feats, case):
    return tit.fit(feats, torch.from_numpy(case["idx"]), torch.from_numpy(case["y"]),
                   kind="diffusion", init=convert.params_from_jax(case["params"]),
                   num_steps=FIT_STEPS, settings=tit.CGSettings(**FIT_SETTINGS),
                   probes=torch.from_numpy(case["probes"]))


def _pathwise(feats, case, full):
    return tit.pathwise_predict(
        feats, convert.params_from_jax(case["predict_params"]), torch.from_numpy(case["idx"]),
        torch.from_numpy(case["y"]), torch.from_numpy(case["test_idx"]), kind="diffusion",
        num_samples=SAMPLES, settings=tit.CGSettings(**SETTINGS), full_space=full,
        eps1=torch.from_numpy(case["eps1"]), eps2=torch.from_numpy(case["eps2"]))


def _rank_work(mesh, inputs):
    """Everything one world size checks, on one rank."""
    out = {"rank": mesh.rank, "size": mesh.size}
    for name, case in inputs["mll"].items():
        if name[0] == "pad" and mesh.size != 4:
            continue
        feats = shard.sharded_features(_port_features(inputs["arrays"][name[0]], name[1]), mesh)
        out[("mll",) + name] = _mll_and_grads(feats, case)
    for layout in LAYOUTS:
        feats = shard.sharded_features(_port_features(inputs["arrays"]["main"], layout), mesh)
        out[("rows", layout)] = feats.rows(ROWS_F, ROWS_IDX)
    fit_case = inputs["fit"]
    feats = shard.sharded_features(_port_features(inputs["arrays"]["fit"], "log"), mesh)
    res = _fit(feats, fit_case)
    out["fit"] = (res.losses, res.params)
    for full in (False, True):
        out[("pathwise", full)] = _pathwise(feats, fit_case, full)
    # the collectives of one Gram matvec, forward: one all-reduce, one all-gather
    phi = tit.contract(feats, torch.tensor([1.0, 0.5, 0.25, 0.125]))
    before = (shard.all_reduces, shard.all_gathers)
    phi.matvec_bm(phi.rmatvec_bm(torch.ones(2, FIT_N)))
    out["collectives"] = (shard.all_reduces - before[0], shard.all_gathers - before[1])
    if mesh.size == 4:
        out["dryrun"] = shard.dryrun_multichip(
            mesh, probes=torch.from_numpy(inputs["dryrun_probes"]))
    return out


# ---------------------------------------------------------------------------
# The inputs, the JAX side and the runs
# ---------------------------------------------------------------------------


def _jax_features(arrays, layout):
    from graphgp_tpu import features as jfeat
    from graphgp_tpu.walker import WalkLog as JWalkLog

    if layout == "log":
        return jfeat.LogFeatures(JWalkLog(arrays["curs"], arrays["loads"]),
                                 num_target_nodes=arrays["n"])
    if layout == "dense":
        return jfeat.DenseFeatures(arrays["dense"])
    return jfeat.EllFeatures(jfeat.EllStepMatrices(arrays["cols"], arrays["vals"], arrays["n"]))


@pytest.fixture(scope="module")
def inputs():
    """Every input, from the JAX package: walk logs of three rings, their
    ELL and dense step matrices, diffusion parameters at noise 0.3, each
    case's probes as JAX's mll_cg draws them, fit's init and per-step probes
    as jit_.fit draws them from its default key, the ε of pathwise_predict
    under key 3, and the dryrun's probes (its key 2)."""
    import jax
    import jax.numpy as jnp

    from graphgp_tpu import WalkConfig as JWalkConfig
    from graphgp_tpu import features as jfeat
    from graphgp_tpu import linalg as jlin
    from graphgp_tpu import pack_laplacian as jpack
    from graphgp_tpu.gp import params as JP
    from graphgp_tpu.walker import sample_walk_log as jwalk

    arrays = {}
    for key, n, seed, wpn, length in (("main", N, 0, WPN, L), ("pad", N_PAD, 1, WPN, L),
                                      ("fit", FIT_N, 0, FIT_WPN, FIT_L)):
        log = jwalk(jpack(_ring(n)), jax.random.PRNGKey(seed),
                    JWalkConfig(walks_per_node=wpn, p_halt=P_HALT, max_walk_length=length))
        ell = jfeat.consolidate(log, R)
        arrays[key] = {"n": n, "curs": np.asarray(log.curs), "loads": np.asarray(log.loads),
                       "cols": np.asarray(ell.cols), "vals": np.asarray(ell.vals),
                       "dense": np.asarray(jfeat.ell_to_dense(ell))}

    params = {k: np.asarray(v) for k, v in
              JP.init_params("diffusion", L, jax.random.PRNGKey(1), noise=0.3).items()}
    names = [("main", lay, sp) for lay in LAYOUTS for sp in SPACES]
    names += [("pad", "log", sp) for sp in SPACES]
    mll_cases = {}
    for i, (data, layout, space) in enumerate(names):
        n = arrays[data]["n"]
        idx = _train_idx(n, space)
        full = space == "full"
        probes = np.asarray(jlin.rademacher_probes(jax.random.PRNGKey(10 + i),
                                                   n if full else idx.size, 4)).T.copy()
        mll_cases[(data, layout, space)] = {
            "params": params, "idx": idx, "y": np.sin(0.2 * idx).astype(np.float32),
            "full": full, "key": 10 + i, "probes": probes}

    idx = np.arange(0, FIT_N, 2).astype(np.int32)
    k_init, k_loop = jax.random.split(jax.random.PRNGKey(0))
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    fit_case = {
        "params": {k: np.asarray(v) for k, v in JP.init_params("diffusion", FIT_L, k_init).items()},
        "idx": idx, "y": np.sin(np.arange(idx.size, dtype=np.float32) * 0.2),
        "probes": np.stack([np.asarray(jlin.rademacher_probes(k, FIT_N, 4)).T
                            for k in jax.random.split(k_loop, FIT_STEPS)]),
        "predict_params": {k: np.asarray(v) for k, v in JP.init_params(
            "diffusion", FIT_L, k_init, noise=0.3, beta=2.0).items()},
        "test_idx": np.arange(1, FIT_N, 2).astype(np.int32),
        "eps1": np.asarray(jax.random.normal(k1, (FIT_N, SAMPLES), jnp.float32)).T.copy(),
        "eps2": np.asarray(jax.random.normal(k2, (idx.size, SAMPLES), jnp.float32)).T.copy(),
    }
    dryrun_probes = np.asarray(jlin.rademacher_probes(jax.random.PRNGKey(2), 16 * 4 // 2,
                                                      4)).T.copy()
    return {"arrays": arrays, "mll": mll_cases, "fit": fit_case, "dryrun_probes": dryrun_probes}


def _jax_results(inputs):
    """JAX's mll_cg and its gradient on the 8-device mesh (the 62-node case
    is the port's alone: 62 rows do not split over 8 devices), its fit as
    tests/test_shard.py's training test runs it, its pathwise_predict, and
    the numbers dryrun_multichip(4) prints."""
    import contextlib
    import io
    import re
    import sys
    from pathlib import Path

    import jax
    import jax.numpy as jnp

    from graphgp_tpu.gp import iterative as jit_
    from graphgp_tpu.shard import make_mesh, shard_features

    mesh = make_mesh(8)
    js = jit_.CGSettings(**SETTINGS)
    mll = {}
    for (data, layout, space), case in inputs["mll"].items():
        if data == "pad":
            continue
        feats = shard_features(_jax_features(inputs["arrays"][data], layout), mesh)
        val, grads = jax.value_and_grad(
            lambda p, f=feats, c=case: jit_.mll_cg(
                f, p, jnp.asarray(c["idx"]), jnp.asarray(c["y"]), jax.random.PRNGKey(c["key"]),
                kind="diffusion",
                settings=js, full_space=c["full"])
        )({k: jnp.asarray(v) for k, v in case["params"].items()})
        mll[(data, layout, space)] = (float(val), {k: np.asarray(g) for k, g in grads.items()})

    case = inputs["fit"]
    feats = shard_features(_jax_features(inputs["arrays"]["fit"], "log"), mesh)
    fit = jit_.fit(feats, jnp.asarray(case["idx"]), jnp.asarray(case["y"]), kind="diffusion",
                   key=jax.random.PRNGKey(0), num_steps=FIT_STEPS,
                   settings=jit_.CGSettings(**FIT_SETTINGS))
    predict_params = {k: jnp.asarray(v) for k, v in case["predict_params"].items()}
    pathwise = {
        full: np.asarray(jit_.pathwise_predict(
            feats, predict_params, jnp.asarray(case["idx"]), jnp.asarray(case["y"]),
            jnp.asarray(case["test_idx"]), jax.random.PRNGKey(3), kind="diffusion",
            num_samples=SAMPLES, settings=js, full_space=full))
        for full in (False, True)
    }

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import __graft_entry__ as ge

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ge.dryrun_multichip(4)
    m = re.search(r"loss=(\S+) solve_norm=(\S+) hmc_accept=\S+ ok", printed.getvalue())
    return {"mll": mll, "fit": (np.asarray(fit.losses), {k: np.asarray(v) for k, v in
                                                         fit.params.items()}),
            "pathwise": pathwise, "dryrun": (float(m.group(1)), float(m.group(2)))}


@pytest.fixture(scope="module")
def runs(inputs):
    """The ranks of world 2 and 4 (in threads, each waiting on its processes)
    while this process computes the JAX results."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        futures = {w: pool.submit(shard.run_ranks, _rank_work, w, inputs, device="cpu",
                                  timeout=RANK_TIMEOUT) for w in (2, 4)}
        refs = _jax_results(inputs)
        return {w: f.result() for w, f in futures.items()}, refs


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def refs(runs):
    return runs[1]


@pytest.fixture(scope="module")
def single(inputs):
    """The port in this process, on the whole features."""
    out = {}
    for name, case in inputs["mll"].items():
        out[("mll",) + name] = _mll_and_grads(
            _port_features(inputs["arrays"][name[0]], name[1]), case)
    res = _fit(_port_features(inputs["arrays"]["fit"], "log"), inputs["fit"])
    out["fit"] = (res.losses, res.params)
    return out


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_mll_cg_and_every_gradient(ranks, refs, single, layout, space, world):
    """The sharded marginal likelihood and its gradient for raw_noise (a
    replicated parameter), raw_beta and raw_sigma_f (through the modulator,
    which meets every rank's block), on every rank, against the port in one
    process and JAX on its 8-device mesh."""
    key = ("main", layout, space)
    ref_val, ref_grads = refs["mll"][key]
    one_val, one_grads = single[("mll",) + key]
    assert abs(one_val - ref_val) <= 1e-4 * abs(ref_val)
    for out in ranks[world]:
        val, grads = out[("mll",) + key]
        assert abs(val - ref_val) <= 1e-4 * abs(ref_val)
        assert abs(val - one_val) <= 1e-4 * abs(one_val)
        assert set(grads) == set(ref_grads) == {"raw_noise", "raw_beta", "raw_sigma_f"}
        for k in grads:
            assert _rel(grads[k].numpy(), ref_grads[k]) <= 1e-4, k
            assert _rel(grads[k].numpy(), one_grads[k].numpy()) <= 1e-4, k


@pytest.mark.parametrize("space", SPACES)
def test_world_that_does_not_divide_the_nodes(ranks, single, space):
    """62 nodes over 4 ranks pad to 64 with zero rows: the loss and every
    gradient of the port in one process."""
    one_val, one_grads = single[("mll", "pad", "log", space)]
    for out in ranks[4]:
        val, grads = out[("mll", "pad", "log", space)]
        assert abs(val - one_val) <= 1e-4 * abs(one_val)
        for k in one_grads:
            assert _rel(grads[k].numpy(), one_grads[k].numpy()) <= 1e-4, k


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fit_matches_jax_loss_by_loss(ranks, refs, single, world):
    """15 Adam steps (the JAX sharded training test's setup, n 128, the full
    node-space solver that fit picks there) under JAX's per-step probes."""
    ref_losses, ref_params = refs["fit"]
    one_losses, one_params = single["fit"]
    assert ref_losses[-1] < ref_losses[0]
    np.testing.assert_allclose(one_losses.numpy(), ref_losses, rtol=1e-3)
    for out in ranks[world]:
        losses, params = out["fit"]
        np.testing.assert_allclose(losses.numpy(), ref_losses, rtol=1e-3)
        np.testing.assert_allclose(losses.numpy(), one_losses.numpy(), rtol=1e-4)
        for k in ref_params:
            np.testing.assert_allclose(params[k].numpy(), ref_params[k], rtol=0, atol=1e-2)
            np.testing.assert_allclose(params[k].numpy(), one_params[k].numpy(), rtol=0,
                                       atol=1e-3)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("full", [False, True])
def test_sharded_pathwise_predict_matches_jax(ranks, refs, full, world):
    """Posterior samples at the odd nodes under JAX's ε (its key 3), both
    solver spaces."""
    for out in ranks[world]:
        got = out[("pathwise", full)].numpy()
        assert got.shape == refs["pathwise"][full].shape == (SAMPLES, FIT_N // 2)
        assert _rel(got, refs["pathwise"][full]) <= 1e-4


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_rows_are_the_whole_rows(ranks, inputs, layout, world):
    """Φ[idx, :] over the split (each row from the rank that holds it, zeros
    from the others, all-reduced) equals the whole features' rows exactly."""
    ref = _port_features(inputs["arrays"]["main"], layout).rows(ROWS_F, ROWS_IDX)
    for out in ranks[world]:
        assert torch.equal(out[("rows", layout)], ref)


@pytest.mark.parametrize("world", [2, 4])
def test_gram_matvec_collectives(ranks, world):
    """A forward Gram matvec Φ(Φᵀv) over the split: one all-reduce, one
    all-gather, whatever the world size."""
    for out in ranks[world]:
        assert out["collectives"] == (1, 1)


def test_ported_dryrun_gives_the_jax_dryrun(ranks, refs):
    """The dryrun's five steps at world 4 with the JAX run's probes: the loss
    and solve norm that JAX's dryrun_multichip(4) prints to 4 decimals, the
    same on every rank."""
    ref_loss, ref_norm = refs["dryrun"]
    outs = [o["dryrun"] for o in ranks[4]]
    assert all(o == outs[0] for o in outs)
    got = outs[0]
    assert abs(got["loss"] - ref_loss) <= 5e-5 + 1e-4 * abs(ref_loss)
    assert abs(got["solve_norm"] - ref_norm) <= 5e-5 + 1e-3 * abs(ref_norm)
    assert 0.0 <= got["hmc_accept"] <= 1.0


def _diverging_ranks(mesh):
    """Rank 0 waits in an all-reduce that rank 1 never joins."""
    import time

    import torch.distributed as dist

    if mesh.rank == 0:
        dist.all_reduce(torch.ones(1))
    else:
        time.sleep(120)


def test_a_rank_that_takes_another_branch_fails_the_run_in_time():
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        shard.run_ranks(_diverging_ranks, 2, device="cpu", timeout=5.0)
    assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_sharded_training_on_the_card():
    """An NCCL group of one on the card: the sharded mll_cg and its gradients
    against the whole features on the card (rel 1e-4; the walk log's
    transposed product adds by atomics), and 5 fit steps (rel 1e-4 losses)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = shard.run_ranks(_card_work, 1, device="cuda", timeout=RANK_TIMEOUT)[0]
    (val, grads), (one_val, one_grads) = out["mll"]
    assert abs(val - one_val) <= 1e-4 * abs(one_val)
    for k in one_grads:
        assert _rel(grads[k].numpy(), one_grads[k].numpy()) <= 1e-4, k
    losses, one_losses = out["fit"]
    np.testing.assert_allclose(losses.numpy(), one_losses.numpy(), rtol=1e-4)


def _card_work(mesh):
    from graphgp_tpu_torch.features import LogFeatures
    from graphgp_tpu_torch.gp import params as P
    from graphgp_tpu_torch.graphs import pack_laplacian
    from graphgp_tpu_torch.walker import WalkConfig, sample_walk_log

    dev = mesh.device
    log = sample_walk_log(pack_laplacian(_ring(FIT_N)).to(dev), 0, WalkConfig(FIT_WPN, P_HALT, L))
    whole = LogFeatures(log, FIT_N)
    split = shard.sharded_features(whole, mesh)
    idx = torch.arange(0, FIT_N, 2, device=dev)
    y = torch.sin(0.2 * idx.float())
    probes = torch.from_numpy(np.random.default_rng(0).choice(
        [-1.0, 1.0], size=(5, 4, FIT_N)).astype(np.float32)).to(dev)
    params0 = P.init_params("diffusion", L, noise=0.3, device=dev)
    out = {"mll": [], "fit": []}
    for feats in (split, whole):
        p = {k: v.clone().requires_grad_(True) for k, v in params0.items()}
        mll = tit.mll_cg(feats, p, idx, y, kind="diffusion", settings=tit.CGSettings(**SETTINGS),
                         full_space=True, probes=probes[0])
        mll.backward()
        out["mll"].append((float(mll.detach()), {k: v.grad.cpu() for k, v in p.items()}))
        res = tit.fit(feats, idx, y, kind="diffusion", init=params0, num_steps=5,
                      settings=tit.CGSettings(**SETTINGS), probes=probes)
        out["fit"].append(res.losses.cpu())
    return out
