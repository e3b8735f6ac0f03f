"""K1's band planner and its adjoint: the plan the CUDA kernels consume, the
weight gradient's plain version against the JAX package (its XLA roll
reduction and jax.vjp of the Pallas kernel in interpret mode), and a backward
that builds no shifted table. The CUDA kernels themselves are tested on the
card by test_torch_cuda_kernels.py.

Tolerance: atol 1e-4, as the existing K1 tests use (float32 sums of up to
B·S terms in another order than XLA's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgp_tpu.pallas_kernels import stencil as ps
from graphgp_tpu_torch.cuda_kernels import stencil as k1
from graphgp_tpu_torch.features import StencilFeatures, StencilStepMatrices, contract
from graphgp_tpu_torch.gp import iterative

ATOL = 1e-4
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
FLAGSHIP = sorted(dx + 1000 * dy for dx in range(-4, 5) for dy in range(-4, 5)
                  if abs(dx) + abs(dy) <= 4)


def _grid_offsets(side):
    return np.asarray(sorted(dx + side * dy for dx in range(-4, 5) for dy in range(-4, 5)
                             if abs(dx) + abs(dy) <= 4), np.int64)


def _ring_offsets(n):
    # a ring's raw vocabulary: short hops and their wraparound twins
    return np.asarray([-2, -1, 0, 1, 2, n - 2, n - 1], np.int64)


def _far_offsets(n, s, seed):
    rng = np.random.default_rng(seed)
    return np.unique(np.concatenate([[0, 1, n - 1], rng.integers(0, n, s)]))[:s]


def _vocabularies():
    n = 1_000_000
    return {
        "flagship": (np.asarray(FLAGSHIP), n),
        "ring wraparound": (_ring_offsets(n), n),
        "far random": (_far_offsets(n, 64, seed=3), n),
        "S=256 far": (_far_offsets(n, 256, seed=4), n),
        "S=256 dense": (np.arange(-128, 128), n),
        "S=256 small ring": (np.arange(256), 300),
    }


@pytest.mark.parametrize("name", list(_vocabularies()))
def test_band_plan_covers_each_offset_once_within_limits(name):
    raw, n = _vocabularies()[name]
    offs = k1.center_offsets(raw, n)
    plan = k1.plan_bands(offs.tolist())
    bands = plan.bands()
    assert plan.num_bands == len(bands)
    rows = [s for _, entries in bands for s, _ in entries]
    assert sorted(rows) == list(range(offs.size))  # every offset in exactly one band
    flat = [o for _, entries in bands for _, o in entries]
    assert flat == sorted(flat)
    for lo, entries in bands:
        got = [o for _, o in entries]
        assert got == [int(offs[s]) for s, _ in entries]
        assert lo == min(got) and max(got) - lo <= k1.SPREAD_LIMIT
        assert 1 <= len(entries) <= k1.BAND_OFFSETS
    assert plan.band_rows == max(len(e) for _, e in bands)
    for b in (1, 16):
        assert plan.smem_bytes(b) <= SMEM_LIMIT
        assert plan.smem_bytes(b, weights=False) < plan.smem_bytes(b)
    assert (plan.tile(1), plan.tile(12), plan.tile(13), plan.tile(16)) == (256, 256, 128, 128)


def test_band_plan_of_the_flagship_has_one_band_per_dy():
    plan = k1.plan_bands(FLAGSHIP)
    bands = plan.bands()
    assert plan.num_bands == 9
    spreads = [max(o for _, o in e) - lo for lo, e in bands]
    assert spreads == [0, 2, 4, 6, 8, 6, 4, 2, 0]
    assert [lo for lo, _ in bands] == [dy * 1000 - (4 - abs(dy)) for dy in range(-4, 5)]
    assert plan.band_rows == 9
    # two stages of a (B, tile + 64) window and 9 rows of w, then the table
    assert plan.smem_bytes(16) == 4 * (2 * (16 * 192 + 9 * 128) + plan.table.size)
    assert plan.smem_bytes(1) == 4 * (2 * (320 + 9 * 256) + plan.table.size)
    # negated offsets (the transposed product) give the mirrored bands
    neg = k1.plan_bands([-o for o in FLAGSHIP]).bands()
    assert [max(o for _, o in e) - lo for lo, e in neg] == spreads


def test_band_plan_keeps_rows_of_unsorted_and_repeated_offsets():
    offs = [5, -3, 70, 5, -200, 0, 64]
    plan = k1.plan_bands(offs)
    for _, entries in plan.bands():
        for s, o in entries:
            assert offs[s] == o
    assert [[o for _, o in e] for _, e in plan.bands()] == [[-200], [-3, 0, 5, 5], [64, 70]]
    with pytest.raises(ValueError):
        k1.plan_bands([])
    with pytest.raises(ValueError):
        k1.plan_bands(list(range(257)))


def _emulate_kernel(plan, w, v, vec):
    """The product as csrc/stencil.cu computes it, from the plan's table:
    per tile of plan.tile(B) columns, per band, a window of v staged from
    the band's first column mod N (aligned down to 4 when ``vec``), read at
    shift + (off − lo) + column."""
    s_count, n = w.shape
    b = v.shape[0]
    tile = plan.tile(b)
    row = tile + k1.WINDOW_PAD
    out = np.zeros_like(v)
    for c0 in range(0, n, tile):
        cols = np.arange(tile)
        acc = np.zeros((b, tile), np.float64)
        for lo, entries in plan.bands():
            start = (c0 + lo) % n
            shift = start % 4 if vec else 0
            spread = max(o for _, o in entries) - lo
            length = shift + tile + spread
            assert -(-length // 4) * 4 <= row if vec else length <= row
            win = v[:, (start - shift + np.arange(row)) % n]
            for s, o in entries:
                wt = np.zeros(tile)
                live = c0 + cols < n
                wt[live] = w[s, c0 + cols[live]]
                acc += wt[None, :] * win[:, shift + (o - lo) + cols]
        keep = c0 + cols < n
        out[:, c0 + cols[keep]] = acc[:, keep]
    return out


@pytest.mark.parametrize("b", [3, 13])  # the two tile widths
@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("case", ["grid", "ring", "far", "tiny"])
def test_band_table_reproduces_the_product(case, vec, b):
    rng = np.random.default_rng(11)
    if case == "grid":
        n, raw = 1600, _grid_offsets(40)
    elif case == "ring":
        n, raw = 516, _ring_offsets(516)
    elif case == "far":
        n, raw = 1000, _far_offsets(1000, 30, seed=1)
    else:  # N below one tile: the window wraps several times
        n, raw = 60, np.asarray([0, 1, 59, 30, 7])
    offs = k1.center_offsets(raw, n)
    w = rng.normal(size=(offs.size, n)).astype(np.float32)
    v = rng.normal(size=(b, n)).astype(np.float32)
    got = _emulate_kernel(k1.plan_bands(offs.tolist()), w, v, vec)
    ref = k1.matvec_plain(torch.from_numpy(w), torch.from_numpy(v), offs.tolist()).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def _stencil_case(kind, b, seed):
    rng = np.random.default_rng(seed)
    n, raw = (1600, _grid_offsets(40)) if kind == "grid" else (515, _ring_offsets(515))
    offs = k1.center_offsets(raw, n)
    w = rng.normal(size=(offs.size, n)).astype(np.float32)
    v = rng.normal(size=(b, n)).astype(np.float32)
    g = rng.normal(size=(b, n)).astype(np.float32)
    return n, raw, offs, w, v, g


@pytest.mark.parametrize("kind", ["grid", "ring"])
@pytest.mark.parametrize("b", [1, 16, 19])
def test_dw_plain_matches_jax_roll_reduction(kind, b):
    _, raw, offs, _, v, g = _stencil_case(kind, b, seed=b)
    ref = ps._dw_matvec(jnp.asarray(v), jnp.asarray(g), tuple(offs.tolist()))
    got = k1._dw_matvec(torch.from_numpy(v), torch.from_numpy(g), offs.tolist())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # raw (uncentred) offsets roll the same way mod N
    raw_got = k1._dw_matvec(torch.from_numpy(v), torch.from_numpy(g), raw.tolist())
    np.testing.assert_allclose(raw_got.numpy(), got.numpy(), atol=0)


@pytest.mark.parametrize("kind", ["grid", "ring"])
@pytest.mark.parametrize("b", [1, 16, 19])
def test_backward_matches_jax_vjp_of_pallas_kernel(kind, b):
    """dw and dv of the port's Function (the plain versions on the CPU)
    equal jax.vjp of the Pallas kernel's custom VJP in interpret mode."""
    n, _, offs, w, v, g = _stencil_case(kind, b, seed=100 + b)
    offs_c = tuple(offs.tolist())
    c = ps._planned_c(n, w.shape[0], b, offs_c, False)
    assert c > 0
    _, vjp = jax.vjp(lambda ww, vv: ps.stencil_matvec_pallas(ww, vv, offs_c, c, True),
                     jnp.asarray(w), jnp.asarray(v))
    dw_j, dv_j = vjp(jnp.asarray(g))
    wt = torch.from_numpy(w).requires_grad_(True)
    vt = torch.from_numpy(v).requires_grad_(True)
    partner = k1.shifted_weights(torch.from_numpy(w), offs_c).requires_grad_(True)
    (k1.stencil_matvec(wt, vt, offs_c, partner) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), atol=ATOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(dv_j), atol=ATOL)
    assert partner.grad is None  # the partner table carries no gradient
    np.testing.assert_allclose(
        k1.dw_matvec(torch.from_numpy(v), torch.from_numpy(g), offs_c).numpy(),
        np.asarray(dw_j), atol=ATOL)


def test_dv_is_the_product_with_the_partner_table():
    """The backward uses the table it is handed: dv = partner-product of g
    under −offsets (a different partner gives a different dv)."""
    n, _, offs, w, v, g = _stencil_case("ring", 4, seed=5)
    offs_c = offs.tolist()
    partner = torch.from_numpy(np.random.default_rng(6).normal(size=w.shape).astype(np.float32))
    vt = torch.from_numpy(v).requires_grad_(True)
    (k1.stencil_matvec(torch.from_numpy(w), vt, offs_c, partner) * torch.from_numpy(g)).sum().backward()
    ref = k1.matvec_plain(partner, torch.from_numpy(g), [-o for o in offs_c])
    torch.testing.assert_close(vt.grad, ref, rtol=0, atol=0)


def _counting(monkeypatch, name):
    calls = []
    real = getattr(k1, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(k1, name, counted)
    return calls


def _ring_features(n=200, l=3, seed=0):
    rng = np.random.default_rng(seed)
    offs = np.asarray([-20, -1, 0, 1, 20, n - 1])
    vals = torch.from_numpy(rng.normal(size=(l, offs.size, n)).astype(np.float32))
    return StencilFeatures(StencilStepMatrices(vals=vals, offsets=offs)), rng


def test_backward_builds_no_table_and_matches_roll_chain_gradient(monkeypatch):
    """contract → rmatvec → matvec: the backward calls shifted_weights 0
    times, and the modulator's gradient equals the roll chain's."""
    feats, rng = _ring_features()
    n = feats.num_nodes
    offs = feats.mats.offsets
    v = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))
    f = torch.tensor([0.7, -0.3, 0.2], requires_grad=True)
    phi = contract(feats, f)
    loss = (phi.matvec_bm(phi.rmatvec_bm(v)) * g).sum()
    tables = _counting(monkeypatch, "shifted_weights")
    loss.backward()
    assert tables == []

    f2 = torch.tensor([0.7, -0.3, 0.2], requires_grad=True)
    w = torch.einsum("l,lsn->sn", f2, feats.mats.vals)
    u = torch.zeros_like(v)
    for s, off in enumerate(offs.tolist()):  # Φᵀ: Σ_s roll(w_s ⊙ v, +off_s)
        u = u + torch.roll(w[s][None, :] * v, off, dims=-1)
    (k1.matvec_plain(w, u, offs.tolist()) * g).sum().backward()
    assert torch.all(f.grad != 0)
    torch.testing.assert_close(f.grad, f2.grad, rtol=1e-5, atol=1e-4)


def test_mll_backward_builds_no_table(monkeypatch):
    """The full-space fit's loss (CG solve and SLQ, whose adjoints
    re-evaluate the Gram product): its backward builds no shifted table,
    reaches the modulator, and takes the gradient of every differentiated
    product through dw_matvec. Full space, since the compact branch solves
    on the train block and runs no stencil product."""
    feats, rng = _ring_features(n=120, seed=1)
    idx = torch.from_numpy(rng.choice(120, 30, replace=False))
    y = torch.from_numpy(rng.normal(size=30).astype(np.float32))
    probes = torch.from_numpy((rng.integers(0, 2, (4, 30)) * 2 - 1).astype(np.float32))
    params = {"raw_noise": torch.tensor(-1.0),
              "modulator": torch.tensor([1.0, 0.5, 0.25], requires_grad=True)}
    mll = iterative.mll_cg(feats, params, idx, y, full_space=True,
                           probes=torch.zeros(4, 120).index_add(1, idx, probes),
                           settings=iterative.CGSettings(cg_tol=1e-6, cg_max_iters=100))
    tables = _counting(monkeypatch, "shifted_weights")
    dws = _counting(monkeypatch, "dw_matvec")
    mll.backward()
    assert tables == []
    assert len(dws) == 4  # two adjoint re-evaluations, two products each
    assert bool(torch.isfinite(params["modulator"].grad).all())
    assert bool((params["modulator"].grad != 0).any())


def test_compact_mll_runs_no_stencil_product(monkeypatch):
    """The compact branch's objective and backward solve on the train
    block: no K1 product, no dw_matvec and no shifted table, and the
    gradient still reaches the modulator."""
    feats, rng = _ring_features(n=120, seed=1)
    idx = torch.from_numpy(rng.choice(120, 30, replace=False))
    y = torch.from_numpy(rng.normal(size=30).astype(np.float32))
    probes = torch.from_numpy((rng.integers(0, 2, (4, 30)) * 2 - 1).astype(np.float32))
    params = {"raw_noise": torch.tensor(-1.0),
              "modulator": torch.tensor([1.0, 0.5, 0.25], requires_grad=True)}
    calls = [_counting(monkeypatch, name) for name in ("_product", "dw_matvec", "shifted_weights")]
    mll = iterative.mll_cg(feats, params, idx, y, probes=probes,
                           settings=iterative.CGSettings(cg_tol=1e-6, cg_max_iters=100))
    mll.backward()
    assert calls == [[], [], []]
    assert bool(torch.isfinite(params["modulator"].grad).all())
    assert bool((params["modulator"].grad != 0).any())


def test_cpu_backward_never_launches():
    k1.launches = k1.dw_launches = 0
    n, _, offs, w, v, g = _stencil_case("ring", 3, seed=9)
    wt = torch.from_numpy(w).requires_grad_(True)
    vt = torch.from_numpy(v).requires_grad_(True)
    partner = k1.shifted_weights(torch.from_numpy(w), offs.tolist())
    (k1.stencil_matvec(wt, vt, offs.tolist(), partner) * torch.from_numpy(g)).sum().backward()
    assert k1.launches == 0 and k1.dw_launches == 0
