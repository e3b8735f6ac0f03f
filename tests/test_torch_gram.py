"""K2, the fused masked-Gram CG: the port's plain versions against the JAX
package's Pallas kernels in interpret mode (``interpret=True, c=128``, as
tests/test_gram.py runs them), and full-space pathwise prediction against the
JAX function under the same draws. The CUDA kernels themselves are tested on
the card by test_torch_cuda_kernels.py.

Tolerances: one product sums S float32 terms in another order than the Pallas
window (atol 1e-5 at these magnitudes); 25 CG iterations amplify that to the
atol 2e-4 the JAX package's own test states; prediction solves run to a tight
tolerance (1e-6) so both packages converge fully, leaving rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphgp_tpu import features as jfeat
from graphgp_tpu import graphs as jgraphs
from graphgp_tpu import walker as jwalker
from graphgp_tpu.gp import iterative as jit_
from graphgp_tpu.pallas_kernels import gram as jgram
from graphgp_tpu.pallas_kernels import stencil as jps
from graphgp_tpu_torch import linalg as tlin
from graphgp_tpu_torch.convert import params_from_jax, stencil_from_numpy
from graphgp_tpu_torch.cuda_kernels import gram as tgram
from graphgp_tpu_torch.features import StencilFeatures, contract
from graphgp_tpu_torch.gp import iterative as tit

C = 128  # the Pallas block width the JAX package's own tests use
MODULATOR = np.asarray([1.0, 0.5, 0.25], np.float32)
NOISE = np.float32(0.25)


def _ring_csr(n):
    m = sp.diags([np.ones(n - 1), np.ones(n - 1)], [1, -1]).tolil()
    m[0, n - 1] = m[n - 1, 0] = 1
    return m.tocsr().astype(np.float32)


def _grid_csr(side):
    idx = np.arange(side * side).reshape(side, side)
    rows = np.concatenate([idx[:, :-1].ravel(), idx[:-1].ravel()])
    cols = np.concatenate([idx[:, 1:].ravel(), idx[1:].ravel()])
    adj = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(idx.size,) * 2)
    return (adj + adj.T).tocsr()


CASES = {
    "ring-periodic": (lambda: _ring_csr(256), True),
    "grid-aperiodic": (lambda: _grid_csr(16), False),
    # n = 225: not a multiple of any block width, a tail in the last block
    "grid-tailed": (lambda: _grid_csr(15), False),
}


def _jax_stencil(adj, wpn=32, length=3):
    log = jwalker.sample_walk_log(jgraphs.pack_laplacian(adj), jax.random.PRNGKey(0),
                                  jwalker.WalkConfig(wpn, 0.1, length))
    mats = jfeat.consolidate(log, jfeat.suggest_row_capacity(log), walks_per_node=wpn)
    stencil = jfeat.ell_to_stencil(mats)
    assert stencil is not None
    return stencil


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def problem(request):
    """One stencil, contracted in both packages, with a half mask and B = 4
    right-hand sides that are zero off the mask."""
    make, periodic = CASES[request.param]
    jm = _jax_stencil(make())
    assert jfeat.stencil_is_periodic(jm) == periodic
    n = jm.vals.shape[2]
    jphi = jfeat.contract(jfeat.StencilFeatures(jm), jnp.asarray(MODULATOR))
    offs = tuple(jps.center_offsets(jphi.offsets, n).tolist())
    jphi = type(jphi)(w=jphi.w, offsets=jphi.offsets,
                      w_shift=jps.shifted_weights(jphi.w, np.asarray(offs)))
    tphi = contract(StencilFeatures(stencil_from_numpy(np.asarray(jm.vals), np.asarray(jm.offsets))),
                    torch.from_numpy(MODULATOR))
    rng = np.random.default_rng(0)
    mask = np.zeros(n, np.float32)
    mask[rng.choice(n, n // 2, replace=False)] = 1.0
    b = rng.normal(size=(4, n)).astype(np.float32) * mask[None, :]
    return dict(jphi=jphi, tphi=tphi, n=n, offs=offs, periodic=periodic, mask=mask, b=b)


def test_gram_cg_plain_matches_jax_gram_cg(problem):
    p = problem
    ref = jgram.gram_cg(p["jphi"], jnp.float32(NOISE), jnp.asarray(p["mask"]), jnp.asarray(p["b"]),
                        tol=0.0, max_iters=25, periodic=p["periodic"], interpret=True, c=C)
    got = tgram.gram_cg_plain(p["tphi"], torch.tensor(NOISE), torch.from_numpy(p["mask"]),
                              torch.from_numpy(p["b"]), tol=0.0, max_iters=25)
    assert got.iterations == int(ref.iterations) == 25
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=2e-4)
    np.testing.assert_allclose(got.residual_norm.numpy(), np.asarray(ref.residual_norm),
                               rtol=1e-2, atol=1e-6)
    # the dispatcher takes the plain version for CPU tensors
    again = tgram.gram_cg(p["tphi"], float(NOISE), torch.from_numpy(p["mask"]),
                          torch.from_numpy(p["b"]), tol=0.0, max_iters=25)
    assert torch.equal(again.x, got.x)


def test_gram_cg_is_the_linalg_loop_on_the_k2_operator(problem):
    """``gram_cg_plain`` is ``linalg``'s CG loop on the plain K2a → K2b
    operator, whose dot is the step's denominator: the same bits, the same
    iterations."""
    p = problem
    tphi, offs = p["tphi"], p["offs"]
    mask_t, b = torch.from_numpy(p["mask"]), torch.from_numpy(p["b"])
    neg = tuple(-o for o in offs)
    nv = torch.tensor([NOISE], dtype=torch.float32)

    def k2(_, v):
        t = tgram.rmv_mask_plain(tphi.w_shift, mask_t, v, neg)
        return tgram.mv_epilogue_plain(tphi.w, t, mask_t, v, nv, offs)

    got = tgram.gram_cg_plain(tphi, torch.tensor(NOISE), mask_t, b, tol=1e-3, max_iters=100)
    ref = tlin.batched_cg(k2, None, b, tol=1e-3, max_iters=100)
    assert isinstance(got, tlin.CGResult)
    assert 0 < got.iterations < 100 and got.iterations == ref.iterations
    assert torch.equal(got.x, ref.x)
    assert torch.equal(got.residual_norm, ref.residual_norm)


@pytest.mark.parametrize("tol", [1e-1, 1e-3])
def test_gram_cg_plain_iteration_count_matches_jax(problem, tol):
    p = problem
    b = p["b"].copy()
    b[1] *= 1e-3  # a system of another scale: relative tolerance, frozen early or late
    b[2] = 0.0  # a zero system: inactive from the start
    ref = jgram.gram_cg(p["jphi"], jnp.float32(NOISE), jnp.asarray(p["mask"]), jnp.asarray(b),
                        tol=tol, max_iters=100, periodic=p["periodic"], interpret=True, c=C)
    got = tgram.gram_cg_plain(p["tphi"], torch.tensor(NOISE), torch.from_numpy(p["mask"]),
                              torch.from_numpy(b), tol=tol, max_iters=100)
    assert 0 < got.iterations < 100
    assert got.iterations == int(ref.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=2e-4)
    assert bool((got.residual_norm <= tol).all())
    assert bool((got.x[2] == 0).all())


def test_k2_passes_match_pallas_interpret(problem):
    """One operator application: K2a's t, K2b's out and the summed dot."""
    p = problem
    n, offs = p["n"], p["offs"]
    neg = tuple(-o for o in offs)
    nb = -(-n // C)
    v = np.random.default_rng(1).normal(size=(4, n)).astype(np.float32)
    jphi = p["jphi"]
    w_p = jgram._pad_weights(jphi.w, n, C, nb)
    ws_p = jgram._pad_weights(jphi.w_shift, n, C, nb)
    mask_p = jgram.pad_state(jnp.asarray(p["mask"])[None, :], n, C, nb)
    real_p = jgram.pad_state(jnp.ones((1, n), jnp.float32), n, C, nb)
    v_p = jgram.pad_state(jnp.asarray(v), n, C, nb)
    if p["periodic"]:
        mask_p = jgram._refresh_pads(mask_p, n, C)
        v_p = jgram._refresh_pads(v_p, n, C)
    t_p = jgram._rmv_mask(ws_p, mask_p, v_p, neg, C, nb, True)
    t_ref = np.asarray(jgram.unpad_state(t_p, n, C))
    if p["periodic"]:
        t_p = jgram._refresh_pads(t_p, n, C)
    out_p, dots = jgram._mv_epilogue(w_p, t_p, mask_p, v_p, real_p,
                                     jnp.full((1, 1), NOISE, jnp.float32), offs, C, nb, True)
    out_ref = np.asarray(jgram.unpad_state(out_p, n, C))
    dot_ref = np.asarray(jnp.sum(dots, axis=1))

    tphi = p["tphi"]
    mask_t, v_t = torch.from_numpy(p["mask"]), torch.from_numpy(v)
    t = tgram.rmv_mask_plain(tphi.w_shift, mask_t, v_t, neg)
    out, dot = tgram.mv_epilogue_plain(tphi.w, t, mask_t, v_t, torch.tensor(NOISE), offs)
    np.testing.assert_allclose(t.numpy(), t_ref, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), out_ref, atol=1e-5)
    np.testing.assert_allclose(dot.numpy(), dot_ref, rtol=1e-5)
    # off the mask the operator is the identity
    off = p["mask"] == 0
    np.testing.assert_array_equal(out.numpy()[:, off], v[:, off])


def test_plain_operator_equals_the_k1_composition(problem):
    """K2a then K2b is ``make_gram_matvec_bm_full`` (two K1 products plus the
    elementwise algebra), the composition the kernels fuse."""
    p = problem
    tphi, offs = p["tphi"], p["offs"]
    mask_t = torch.from_numpy(p["mask"])
    v = torch.from_numpy(np.random.default_rng(2).normal(size=(3, p["n"])).astype(np.float32))
    t = tgram.rmv_mask_plain(tphi.w_shift, mask_t, v, tuple(-o for o in offs))
    out, dot = tgram.mv_epilogue_plain(tphi.w, t, mask_t, v, torch.tensor(NOISE), offs)
    ref = tit.make_gram_matvec_bm_full()((tphi, torch.tensor(NOISE), mask_t), v)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(dot, (v * ref).sum(dim=1), rtol=1e-5, atol=1e-5)


def test_twenty_right_hand_sides_equal_two_chunked_solves(problem):
    p = problem
    rng = np.random.default_rng(3)
    b = torch.from_numpy(rng.normal(size=(20, p["n"])).astype(np.float32) * p["mask"][None, :])
    mask_t = torch.from_numpy(p["mask"])
    settings = tit.CGSettings(cg_tol=1e-4, cg_max_iters=200)
    x = tit._fused_gram_solve_bm(p["tphi"], torch.tensor(NOISE), mask_t, b, settings)
    assert x.shape == (20, p["n"])
    for lo, hi in ((0, 16), (16, 20)):
        part = tgram.gram_cg(p["tphi"], torch.tensor(NOISE), mask_t, b[lo:hi], tol=1e-4,
                             max_iters=200)
        assert torch.equal(x[lo:hi], part.x)
    with pytest.raises(ValueError, match="chunks"):
        tgram.gram_cg(p["tphi"], torch.tensor(NOISE), mask_t, b)


def test_cuda_wrappers_refuse_cpu_tensors(problem):
    """The kernel wrappers never fall back: a CPU tensor is an error there
    (``gram_cg`` is what sends CPU tensors to the plain versions)."""
    p = problem
    tphi = p["tphi"]
    mask_t, v = torch.from_numpy(p["mask"]), torch.from_numpy(p["b"])
    neg = tuple(-o for o in p["offs"])
    with pytest.raises(ValueError, match="CUDA"):
        tgram.rmv_mask_cuda(tphi.w_shift, mask_t, v, neg)
    with pytest.raises(ValueError, match="CUDA"):
        tgram.mv_epilogue_cuda(tphi.w, v, mask_t, v, torch.tensor([NOISE]), p["offs"])
    assert tgram.rmv_mask_launches == 0 and tgram.mv_epilogue_launches == 0


# ---------------------------------------------------------------------------
# Full-space pathwise prediction against the JAX function, same draws.
# ---------------------------------------------------------------------------

SETTINGS = dict(cg_tol=1e-6, cg_max_iters=400, num_probes=8, num_lanczos_iters=10)


@pytest.fixture(scope="module")
def grid_pair():
    from graphgp_tpu.data.synthetic import generate

    data = generate("grid", 400, seed=0)
    jm = _jax_stencil(data["adjacency"], wpn=64, length=4)
    jf = jfeat.StencilFeatures(jm)
    tf = StencilFeatures(stencil_from_numpy(np.asarray(jm.vals), np.asarray(jm.offsets)))
    return jf, tf, data["y_observed"].astype(np.float32)


def _observations(y_all, masked, n_real=120, pad=8, seed=0):
    """Distinct train ids (node 0 among them); the masked variant appends
    padded slots that point at node 0 with y = 0, as a fixed-capacity buffer
    does."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(np.arange(1, y_all.size), n_real - 1, replace=False)
    idx = np.concatenate([[0], idx]).astype(np.int32)
    y = y_all[idx]
    if not masked:
        return idx, y, None
    idx = np.concatenate([idx, np.zeros(pad, np.int32)])
    y = np.concatenate([y, np.zeros(pad, np.float32)])
    mask = (np.arange(idx.size) < n_real).astype(np.float32)
    return idx, y, mask


def _torch_predict(tf, p0, idx, y, mask, test_idx, eps1, eps2, full_space):
    return tit.pathwise_predict(
        tf, params_from_jax(p0), torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(y),
        torch.from_numpy(test_idx.astype(np.int64)), num_samples=eps1.shape[0],
        settings=tit.CGSettings(**SETTINGS),
        mask=None if mask is None else torch.from_numpy(mask),
        full_space=full_space, eps1=torch.from_numpy(eps1), eps2=torch.from_numpy(eps2),
    )


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "padded-mask"])
def test_pathwise_full_space_matches_jax_given_same_draws(grid_pair, masked):
    jf, tf, y_all = grid_pair
    idx, y, mask = _observations(y_all, masked)
    p0 = {"raw_noise": np.float32(-1.5),
          "modulator": np.random.default_rng(1).normal(size=4).astype(np.float32)}
    test_idx = np.arange(0, 400, 3, dtype=np.int32)
    key = jax.random.PRNGKey(9)
    ref = jit_.pathwise_predict(
        jf, {k: jnp.asarray(v) for k, v in p0.items()}, jnp.asarray(idx), jnp.asarray(y),
        jnp.asarray(test_idx), key, kind="free", num_samples=5,
        settings=jit_.CGSettings(**SETTINGS),
        mask=None if mask is None else jnp.asarray(mask), full_space=True,
    )
    k1_, k2_ = jax.random.split(key)
    eps1 = np.asarray(jax.random.normal(k1_, (400, 5), jnp.float32)).T.copy()
    eps2 = np.asarray(jax.random.normal(k2_, (idx.size, 5), jnp.float32)).T.copy()
    out = _torch_predict(tf, p0, idx, y, mask, test_idx, eps1, eps2, full_space=True)
    assert out.shape == (5, test_idx.size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "padded-mask"])
def test_pathwise_full_space_equals_compact_in_the_port(grid_pair, masked):
    _, tf, y_all = grid_pair
    idx, y, mask = _observations(y_all, masked, seed=4)
    p0 = {"raw_noise": np.float32(-1.0),
          "modulator": np.random.default_rng(5).normal(size=4).astype(np.float32)}
    rng = np.random.default_rng(6)
    eps1 = rng.normal(size=(20, 400)).astype(np.float32)  # 20 samples: two K2 chunks
    eps2 = rng.normal(size=(20, idx.size)).astype(np.float32)
    test_idx = np.arange(400, dtype=np.int32)
    full = _torch_predict(tf, p0, idx, y, mask, test_idx, eps1, eps2, full_space=True)
    compact = _torch_predict(tf, p0, idx, y, mask, test_idx, eps1, eps2, full_space=False)
    np.testing.assert_allclose(full.numpy(), compact.numpy(), rtol=1e-4, atol=1e-4)
    assert bool(torch.isfinite(full).all())
