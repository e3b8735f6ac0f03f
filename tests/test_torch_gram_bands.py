"""K2a and K2b as the banded kernels compute them: numpy emulations of
csrc/gram.cu driven from the band planner's table (the windows of the operand
and, for K2a, of the mask; K2b's epilogue and its partial sums per block in
the kernel's fixed order), held against the plain versions and against the
JAX package's Pallas kernels in interpret mode (``interpret=True, c=128``, as
tests/test_torch_gram.py runs them). The CUDA kernels themselves are tested
on the card by test_torch_cuda_kernels.py.

Tolerances: one product sums S float32 terms in another order (atol 1e-5,
as test_torch_gram.py states); the dot sums N float32 terms in another order
(rtol 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgp_tpu.pallas_kernels import gram as jgram
from graphgp_tpu_torch.cuda_kernels import gram as k2
from graphgp_tpu_torch.cuda_kernels import stencil as k1
from test_torch_stencil_adjoint import SMEM_LIMIT, _far_offsets, _ring_offsets, _vocabularies

ATOL = 1e-5
THREADS = 128  # csrc/bands.cuh: kThreads
C = 128  # the Pallas block width the JAX package's own tests use
NOISE = np.float32(0.3)


def _grid_offsets(side, order="sorted"):
    pairs = [(dx, dy) for dx in range(-4, 5) for dy in range(-4, 5) if abs(dx) + abs(dy) <= 4]
    offs = [dx + side * dy for dx, dy in pairs]  # dx-major
    return np.asarray(offs if order == "dx-major" else sorted(offs), np.int64)


def _case(name, b, seed=0):
    """(n, centred offsets, w, w_shift, mask, v), seeded: N = 900, 516 and 1000 are
    multiples of 4 (16-byte copies possible) and of no tile width, so the
    last block has a tail; N = 60 is below one tile."""
    n, raw = {
        "grid": (900, _grid_offsets(30)),
        "ring": (516, _ring_offsets(516)),
        "far": (1000, _far_offsets(1000, 30, seed=1)),
        "tiny": (60, np.asarray([0, 1, 59, 30, 7])),
    }[name]
    rng = np.random.default_rng(seed)
    offs = k1.center_offsets(raw, n)
    # weights of a unit-variance product, as a contracted stencil's are small
    w = (rng.normal(size=(offs.size, n)) / np.sqrt(offs.size)).astype(np.float32)
    w_shift = k1.shifted_weights(torch.from_numpy(w), offs.tolist()).numpy()
    mask = (rng.random(n) < 0.5).astype(np.float32)
    v = rng.normal(size=(b, n)).astype(np.float32)
    return n, offs, w, w_shift, mask, v


def _banded_product(plan, w, x, mask, vec):
    """Per block of plan.tile(B) columns, (B, tile) accumulators of
    Σ_s w[s, i] · m[j] · x[b, j], j = (i + off_s) mod N, from the plan's
    bands: each band's window of x (and of the mask when given) staged from
    the band's first column mod N, aligned down to 4 when ``vec``, read at
    shift + (off − lo) + column. Weights past N are never staged: NaN here,
    as the kernel's shared memory holds whatever was there."""
    n = w.shape[1]
    b = x.shape[0]
    tile = plan.tile(b)
    row = tile + k1.WINDOW_PAD
    cols = np.arange(tile)
    for c0 in range(0, n, tile):
        live = c0 + cols < n
        acc = np.zeros((b, tile), np.float64)
        for lo, entries in plan.bands():
            start = (c0 + lo) % n
            shift = start % 4 if vec else 0
            length = shift + tile + max(o for _, o in entries) - lo
            assert (-(-length // 4) * 4 if vec else length) <= row
            idx = (start - shift + np.arange(row)) % n
            for s, o in entries:
                wt = np.full(tile, np.nan)
                wt[live] = w[s, c0 + cols[live]]
                at = shift + (o - lo) + cols
                if mask is not None:
                    wt = wt * mask[idx][at]  # the mask row, folded into the weight
                acc += wt[None, :] * x[:, idx][:, at]
        yield c0, live, acc.astype(np.float32)


def _emulate_rmv_mask(w_shift, mask, v, neg, vec):
    plan = k1.plan_bands(list(neg))
    t = np.zeros_like(v)
    for c0, live, acc in _banded_product(plan, w_shift, v, mask, vec):
        t[:, c0 + np.flatnonzero(live)] = acc[:, live]
    return t


def _emulate_mv_epilogue(w, t, mask, v, nv, offs, vec):
    """K2b: the product over t, the epilogue on the accumulators, and one
    partial of v·out per (row, block): a thread's columns in order, a warp's
    shuffle tree (lane 0 takes lanes 0..31 by halves), the warps in order,
    all in float32."""
    plan = k1.plan_bands(list(offs))
    b, n = v.shape
    tile = plan.tile(b)
    out = np.zeros_like(v)
    partials = []
    for c0, live, acc in _banded_product(plan, w, t, None, vec):
        col = c0 + np.flatnonzero(live)
        m = mask[col][None, :]
        vb = v[:, col]
        o = m * acc[:, live] + (nv * m) * vb + (np.float32(1.0) - m) * vb
        out[:, col] = o
        terms = np.zeros((b, tile), np.float32)  # the tail adds zero
        terms[:, live] = vb * o
        lanes = np.zeros((b, THREADS), np.float32)
        for p in range(tile // THREADS):
            lanes += terms[:, p * THREADS:(p + 1) * THREADS]
        warps = lanes.reshape(b, THREADS // 32, 32)
        for d in (16, 8, 4, 2, 1):
            warps[:, :, :d] = warps[:, :, :d] + warps[:, :, d:2 * d]
        part = np.zeros(b, np.float32)
        for k in range(THREADS // 32):
            part = part + warps[:, k, 0]
        partials.append(part)
    return out, np.stack(partials, axis=1)


def _plain(n, offs, w, w_shift, mask, v, t):
    neg = [-int(o) for o in offs]
    t_ref = k2.rmv_mask_plain(torch.from_numpy(w_shift), torch.from_numpy(mask),
                              torch.from_numpy(v), neg).numpy()
    out_ref, dot_ref = k2.mv_epilogue_plain(
        torch.from_numpy(w), torch.from_numpy(t), torch.from_numpy(mask), torch.from_numpy(v),
        torch.tensor(NOISE), offs.tolist())
    return t_ref, out_ref.numpy(), dot_ref.numpy()


CASES = ["grid", "ring", "far", "tiny"]


@pytest.mark.parametrize("b", [3, 13])  # the two tile widths
@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_k2a_band_table_reproduces_rmv_mask(case, vec, b):
    n, offs, w, w_shift, mask, v = _case(case, b)
    neg = -offs
    got = _emulate_rmv_mask(w_shift, mask, v, neg, vec)
    t_ref, _, _ = _plain(n, offs, w, w_shift, mask, v, v)
    np.testing.assert_allclose(got, t_ref, atol=ATOL)
    # the shared memory K2a's wrapper asks for: one more window row, the mask's
    plan = k1.plan_bands(neg.tolist())
    tile = plan.tile(b)
    assert plan.smem_bytes(b, mask=True) == 4 * (
        2 * ((b + 1) * (tile + k1.WINDOW_PAD) + plan.band_rows * tile) + plan.table.size)


@pytest.mark.parametrize("b", [3, 13])
@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_k2b_band_table_reproduces_epilogue_and_partials(case, vec, b):
    n, offs, w, w_shift, mask, v = _case(case, b, seed=1)
    t = np.random.default_rng(2).normal(size=v.shape).astype(np.float32)
    out, partials = _emulate_mv_epilogue(w, t, mask, v, NOISE, offs, vec)
    _, out_ref, dot_ref = _plain(n, offs, w, w_shift, mask, v, t)
    np.testing.assert_allclose(out, out_ref, atol=ATOL)
    tile = k1.BandPlan.tile(b)
    assert partials.shape == (b, -(-n // tile))  # one per (row, block)
    assert np.isfinite(partials).all()  # the tail's garbage accumulators add nothing
    np.testing.assert_allclose(partials.sum(axis=1), dot_ref, rtol=1e-5)
    last = (partials.shape[1] - 1) * tile
    # the last block's partial is its live columns' sum alone (float32 sums
    # of up to 256 terms in another order: 1e-4 where they nearly cancel)
    np.testing.assert_allclose(partials[:, -1], (v[:, last:] * out_ref[:, last:]).sum(axis=1),
                               rtol=1e-5, atol=1e-4)
    off = mask == 0
    np.testing.assert_array_equal(out[:, off], v[:, off])  # the identity rows, exactly


@pytest.mark.parametrize("b", [3, 13])
@pytest.mark.parametrize("case", ["grid", "ring"])
def test_band_tables_match_pallas_interpret(case, b):
    """One operator application through the band tables (16-byte copies)
    against _rmv_mask and _mv_epilogue in interpret mode. The offsets are
    within ±C and the pads mirrored (periodic), so the Pallas windows wrap
    mod N as the kernels do."""
    n, offs, w, w_shift, mask, v = _case(case, b, seed=3)
    neg = -offs
    assert np.abs(offs).max() <= C and n >= C
    nb = -(-n // C)
    mask_p = jgram._refresh_pads(jgram.pad_state(jnp.asarray(mask)[None, :], n, C, nb), n, C)
    v_p = jgram._refresh_pads(jgram.pad_state(jnp.asarray(v), n, C, nb), n, C)
    real_p = jgram.pad_state(jnp.ones((1, n), jnp.float32), n, C, nb)
    t_p = jgram._rmv_mask(jgram._pad_weights(jnp.asarray(w_shift), n, C, nb), mask_p, v_p,
                          tuple(neg.tolist()), C, nb, True)
    t_ref = np.asarray(jgram.unpad_state(t_p, n, C))
    out_p, dots = jgram._mv_epilogue(
        jgram._pad_weights(jnp.asarray(w), n, C, nb), jgram._refresh_pads(t_p, n, C), mask_p, v_p,
        real_p, jnp.full((1, 1), NOISE, jnp.float32), tuple(offs.tolist()), C, nb, True)

    t = _emulate_rmv_mask(w_shift, mask, v, neg, vec=True)
    np.testing.assert_allclose(t, t_ref, atol=ATOL)
    # K2b over the Pallas kernel's t: one product each
    out, partials = _emulate_mv_epilogue(w, t_ref, mask, v, NOISE, offs, vec=True)
    np.testing.assert_allclose(out, np.asarray(jgram.unpad_state(out_p, n, C)), atol=ATOL)
    np.testing.assert_allclose(partials.sum(axis=1), np.asarray(jnp.sum(dots, axis=1)), rtol=1e-5)


@pytest.mark.parametrize("b", [3, 13])
def test_dx_major_order_gives_the_sorted_result(b):
    """The planner sorts: the same offsets, with the weight rows in the same
    order as them, give the same plan and bit for bit the same t, out and
    partials in dx-major order as in sorted order."""
    n = 900
    order = np.argsort(_grid_offsets(30, "dx-major"), kind="stable")
    _, offs, w, w_shift, mask, v = _case("grid", b, seed=4)
    inv = np.argsort(order)  # the sorted case's rows in dx-major order
    offs_dx, w_dx, ws_dx = offs[inv], w[inv], w_shift[inv]
    assert offs_dx.tolist() == k1.center_offsets(_grid_offsets(30, "dx-major"), n).tolist()
    bands = [[o for _, o in e] for _, e in k1.plan_bands(offs_dx.tolist()).bands()]
    assert bands == [[o for _, o in e] for _, e in k1.plan_bands(offs.tolist()).bands()]
    for vec in (False, True):
        t = _emulate_rmv_mask(w_shift, mask, v, -offs, vec)
        np.testing.assert_array_equal(_emulate_rmv_mask(ws_dx, mask, v, -offs_dx, vec), t)
        out, part = _emulate_mv_epilogue(w, t, mask, v, NOISE, offs, vec)
        out_dx, part_dx = _emulate_mv_epilogue(w_dx, t, mask, v, NOISE, offs_dx, vec)
        np.testing.assert_array_equal(out_dx, out)
        np.testing.assert_array_equal(part_dx, part)


@pytest.mark.parametrize("name", list(_vocabularies()))
def test_k2_shared_memory_fits_every_vocabulary(name):
    """A block of K2a (B + 1 window rows) and of K2b (K1's layout) fits in
    an H100's 232,448 bytes at B = 16 under the planner's bands of any
    vocabulary."""
    raw, n = _vocabularies()[name]
    offs = k1.center_offsets(raw, n)
    for plan in (k1.plan_bands((-offs).tolist()), k1.plan_bands(offs.tolist())):
        assert plan.smem_bytes(16, mask=True) <= SMEM_LIMIT
        assert plan.smem_bytes(16) < plan.smem_bytes(16, mask=True)
        assert plan.smem_bytes(16, mask=True) - plan.smem_bytes(16) == 4 * 2 * (128 + k1.WINDOW_PAD)
