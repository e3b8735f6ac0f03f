"""The CUDA kernels K1 (stencil product) and its dw (weight gradient), K2
(the two passes of the fused masked-Gram CG), K3 (ELL → stencil) and K4
(fused walks → dense step matrices) against their plain PyTorch versions, on
the card. Marked ``gpu``; each test skips, inside its fixture, when there is
no CUDA card (the kernels have no CPU mode).

This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest -m gpu -q tests/test_torch_cuda_kernels.py

Tolerances: K1 sums S float32 terms with fma in another order than the
plain roll chain (relative 1e-5 of max |ref|), dw B terms, and so do K2a
and K2b; dw and K2b's partials sum in a fixed order, so two launches are
equal; K2b's fused dot is a float32 sum of N terms in another order
(relative 1e-5); K3 places at most one entry
per output cell, so it is exact. K4 walks the plain version's walks bit for bit
and differs in the order of up to W float32 additions per cell (shared-memory
atomics) and in dividing by W after the sum, where the plain version adds W
copies of fl(load / W) one after another (its own error is up to W · 2^-24 of
the largest cell): 3e-5 of max |ref|; two launches of the kernel differ by
summation order only, 1e-5.
"""
import numpy as np
import pytest
import torch

from graphgp_tpu_torch.cuda_kernels import gram as k2
from graphgp_tpu_torch.cuda_kernels import stencil as k1
from graphgp_tpu_torch.cuda_kernels import stencil_build as k3
from graphgp_tpu_torch.cuda_kernels import walker as k4
from graphgp_tpu_torch.data import synthetic
from graphgp_tpu_torch.graphs import PackedGraph, pack_dense, pack_laplacian
from graphgp_tpu_torch.walker import WalkConfig


def _random_stencil(n, s, seed, big_offsets=False):
    rng = np.random.default_rng(seed)
    if big_offsets:  # wraparound-style offsets (ring N−1 ≡ −1) and far ones
        offs = np.unique(np.concatenate([[0, 1, n - 1], rng.integers(0, n, s)]))[:s]
    else:
        offs = np.unique(rng.integers(-5, 6, s))
    w = rng.normal(size=(offs.size, n)).astype(np.float32)
    return w, offs.astype(np.int64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,b,s,big", [(1000, 1, 9, False), (4099, 16, 41, False),
                                       (777, 17, 7, True), (50_000, 5, 256, True)])
def test_k1_kernel_matches_plain(cuda, n, b, s, big):
    w, offs = _random_stencil(n, s, seed=n, big_offsets=big)
    w = torch.from_numpy(w).to(cuda)
    v = torch.randn((b, n), device=cuda)
    before = k1.launches
    w_shift = k1.shifted_weights(w, k1.center_offsets(offs, n))
    out_m = k1.matvec_bm(w, v, offs, w_shift)
    out_r = k1.rmatvec_bm(w_shift, v, offs, w)
    torch.cuda.synchronize()
    assert k1.launches - before == 2 * -(-b // k1.MAX_BATCH)
    offs_c = k1.center_offsets(offs, n).tolist()
    ref_m = k1.matvec_plain(w, v, offs_c)
    ref_r = torch.zeros_like(v)
    for si, off in enumerate(offs_c):
        ref_r = ref_r + torch.roll(w[si][None, :] * v, off, dims=-1)
    for out, ref in ((out_m, ref_m), (out_r, ref_r)):
        err = (out - ref).abs().max() / ref.abs().max()
        assert float(err) <= 1e-5  # fp32 sums of S terms, fma and another order


@pytest.mark.gpu
def test_k1_kernel_gradients_match_plain(cuda):
    n, b = 10_007, 16
    w, offs = _random_stencil(n, 13, seed=5)
    w = torch.from_numpy(w).to(cuda)
    v = torch.randn((b, n), device=cuda)
    g = torch.randn((b, n), device=cuda)
    offs_c = k1.center_offsets(offs, n).tolist()
    wk, vk = w.clone().requires_grad_(True), v.clone().requires_grad_(True)
    (k1.stencil_matvec(wk, vk, offs_c, k1.shifted_weights(w, offs_c)) * g).sum().backward()
    wp, vp = w.clone().requires_grad_(True), v.clone().requires_grad_(True)
    (k1.matvec_plain(wp, vp, offs_c) * g).sum().backward()
    torch.testing.assert_close(wk.grad, wp.grad, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(vk.grad, vp.grad, rtol=1e-5, atol=1e-4)


_FLAGSHIP = tuple(sorted(dx + 1000 * dy for dx in range(-4, 5) for dy in range(-4, 5)
                         if abs(dx) + abs(dy) <= 4))

# (N, offsets, B): N not a multiple of the tile; N % 4 == 0 (16-byte copies)
# and not; far offsets, each its own band, with the ring's seam inside a
# tile; S = 256 far and S = 256 dense (bands of 16 offsets); N below one
# tile; the flagship's offsets at N = 1e6.
_K1_CASES = {
    "n1000-s9-b1": (1000, "small9", 1),
    "n4099-s41-b16": (4099, "small41", 16),
    "n4096-s41-b5": (4096, "small41", 5),
    "n777-far-b8": (777, "far7", 8),
    "n50000-far256-b16": (50_000, "far256", 16),
    "n1001-dense256-b16": (1001, "dense256", 16),
    "n60-tiny-b3": (60, "tiny", 3),
    "flagship-b1": (1_000_000, "flagship", 1),
    "flagship-b8": (1_000_000, "flagship", 8),
    "flagship-b16": (1_000_000, "flagship", 16),
}


def _k1_case(name, device):
    n, kind, b = _K1_CASES[name]
    if kind.startswith("small"):
        w, offs = _random_stencil(n, int(kind[5:]), seed=n)
    elif kind.startswith("far"):
        w, offs = _random_stencil(n, int(kind[3:]), seed=n, big_offsets=True)
    else:
        offs = {"dense256": np.arange(-128, 128), "tiny": np.asarray([0, 1, 59, 30, 7]),
                "flagship": np.asarray(_FLAGSHIP)}[kind]
        w = np.random.default_rng(n).normal(size=(offs.size, n)).astype(np.float32)
    offs_c = tuple(k1.center_offsets(offs, n).tolist())
    gen = torch.Generator(device=device).manual_seed(n + b)
    w = torch.from_numpy(w).to(device)
    v = torch.randn((b, n), generator=gen, device=device)
    g = torch.randn((b, n), generator=gen, device=device)
    return w, v, g, offs_c


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_K1_CASES))
def test_k1_banded_kernels_match_plain(cuda, name):
    """The banded product, forward and transposed, and the dw kernel against
    their plain versions; dw bit-identical on repeat."""
    w, v, g, offs = _k1_case(name, cuda)
    neg = tuple(-o for o in offs)
    w_shift = k1.shifted_weights(w, offs).contiguous()
    before = (k1.launches, k1.dw_launches)
    out = k1.stencil_matvec_cuda(w, v, offs)
    out_t = k1.stencil_matvec_cuda(w_shift, v, neg)
    dw = k1.stencil_dw_cuda(v, g, offs)
    dw_again = k1.stencil_dw_cuda(v, g, offs)
    dw_t = k1.stencil_dw_cuda(v, g, neg)
    torch.cuda.synchronize()
    assert (k1.launches - before[0], k1.dw_launches - before[1]) == (2, 3)
    ref_t = torch.zeros_like(v)
    for si, off in enumerate(offs):  # Σ_s roll(w_s ⊙ v, +off_s): no shifted table
        ref_t = ref_t + torch.roll(w[si][None, :] * v, off, dims=-1)
    assert _rel(out, k1.matvec_plain(w, v, offs)) <= 1e-5  # fp32 sums of S terms, fma, another order
    assert _rel(out_t, ref_t) <= 1e-5
    assert _rel(dw, k1._dw_matvec(v, g, offs)) <= 1e-5  # fp32 sums of B terms, fma
    assert _rel(dw_t, k1._dw_matvec(v, g, neg)) <= 1e-5
    assert torch.equal(dw, dw_again)  # no atomics: a fixed order over b


@pytest.mark.gpu
def test_k1_kernels_take_unaligned_rows(cuda):
    """Rows that do not start on 16 bytes (a view one float into a buffer)
    take the 4-byte copies; N % 4 == 0 would otherwise pick 16."""
    w, v, g, offs = _k1_case("n4096-s41-b5", cuda)
    n = v.shape[1]
    buf = torch.empty(v.numel() + 1, device=cuda)
    v_odd = buf[1:].view(v.shape)
    v_odd.copy_(v)
    assert v_odd.is_contiguous() and v_odd.data_ptr() % 16 != 0
    out = k1.stencil_matvec_cuda(w, v_odd, offs)
    dw = k1.stencil_dw_cuda(v_odd, g, offs)
    assert _rel(out, k1.matvec_plain(w, v, offs)) <= 1e-5
    assert _rel(dw, k1._dw_matvec(v, g, offs)) <= 1e-5
    assert n % 4 == 0


@pytest.mark.gpu
@pytest.mark.parametrize("b", [19, 33])
def test_k1_dw_sums_row_chunks_in_a_fixed_order(cuda, b):
    w, _, _, offs = _k1_case("n4099-s41-b16", cuda)
    n = w.shape[1]
    gen = torch.Generator(device=cuda).manual_seed(b)
    v = torch.randn((b, n), generator=gen, device=cuda)
    g = torch.randn((b, n), generator=gen, device=cuda)
    before = k1.dw_launches
    dw = k1.dw_matvec(v, g, offs)
    again = k1.dw_matvec(v, g, offs)
    torch.cuda.synchronize()
    assert k1.dw_launches - before == 2 * -(-b // k1.MAX_BATCH)
    assert _rel(dw, k1._dw_matvec(v, g, offs)) <= 1e-5
    assert torch.equal(dw, again)


@pytest.mark.gpu
def test_k1_autograd_uses_the_kernels_and_builds_no_table(cuda, monkeypatch):
    """ContractedStencil's two products differentiated on the card: every
    backward takes dw from the kernel, none calls the plain reduction or
    builds a table, and the gradients match the plain path's."""
    w, v, g, offs = _k1_case("n4099-s41-b16", cuda)
    w_shift = k1.shifted_weights(w, offs)
    wk, sk = w.clone().requires_grad_(True), w_shift.clone().requires_grad_(True)
    vk = v.clone().requires_grad_(True)
    loss = (k1.stencil_matvec(wk, k1.stencil_matvec(sk, vk, [-o for o in offs], wk), offs, sk)
            * g).sum()
    plain_calls = []
    monkeypatch.setattr(k1, "_dw_matvec", lambda *a: plain_calls.append(1))
    monkeypatch.setattr(k1, "shifted_weights", lambda *a: plain_calls.append(1))
    before = k1.dw_launches
    loss.backward()
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert plain_calls == [] and k1.dw_launches - before == 2
    wp, sp = w.clone().requires_grad_(True), w_shift.clone().requires_grad_(True)
    vp = v.clone().requires_grad_(True)
    neg = [-o for o in offs]
    (k1.matvec_plain(wp, k1.matvec_plain(sp, vp, neg), offs) * g).sum().backward()
    for got, ref in ((wk.grad, wp.grad), (sk.grad, sp.grad), (vk.grad, vp.grad)):
        assert _rel(got, ref) <= 1e-5


@pytest.mark.gpu
def test_k1_dw_wrapper_rejects_bad_inputs(cuda):
    v = torch.randn(2, 100, device=cuda)
    with pytest.raises(ValueError):
        k1.stencil_dw_cuda(v, torch.randn(3, 100, device=cuda), (0, 1, -1))
    with pytest.raises(ValueError):
        k1.stencil_dw_cuda(torch.randn(17, 100, device=cuda), torch.randn(17, 100, device=cuda),
                           (0, 1, -1))
    with pytest.raises(ValueError):
        k1.stencil_dw_cuda(v, torch.randn(2, 100), (0, 1, -1))
    with pytest.raises(ValueError):
        k1.stencil_dw_cuda(v, torch.randn(100, 2, device=cuda).T, (0, 1, -1))
    with pytest.raises(ValueError):
        k1.stencil_dw_cuda(v.double(), v.double(), (0, 1, -1))
    with pytest.raises(ValueError):
        k1.stencil_dw_cuda(v, v, (0, 1, 100))  # not centred
    with pytest.raises(ValueError):
        k1.stencil_dw_cuda(v, v, tuple(range(-128, 129)))  # S = 257


@pytest.mark.gpu
@pytest.mark.parametrize("l,n,r,s", [(5, 1000, 56, 41), (2, 129, 3, 256), (1, 70_001, 9, 17)])
def test_k3_kernel_equals_plain(cuda, l, n, r, s):
    # s = 256 needs 132 KB of dynamic shared memory (the opt-in path). Rows
    # hold distinct vocabulary offsets, as consolidation produces, padded
    # with (0, 0.0) slots when R > S, plus some off-vocabulary entries.
    gen = np.random.default_rng(s)
    vocab = np.sort(gen.choice(np.arange(-n + 1, n), s, replace=False))
    k = min(r, s)
    diffs = np.zeros((l * n, r), np.int64)
    diffs[:, :k] = np.stack([gen.permutation(vocab)[:k] for _ in range(l * n)])
    off_vocab = np.setdiff1d(np.arange(-n + 1, n), vocab)[:1]
    stray = gen.random((l * n, r)) < 0.05
    diffs[stray] = off_vocab
    diffs = diffs.reshape(l, n, r)
    vals = gen.normal(size=(l, n, r)).astype(np.float32)
    vals[gen.random((l, n, r)) < 0.3] = 0.0
    vals[:, :, k:] = np.where(stray.reshape(l, n, r)[:, :, k:], vals[:, :, k:], 0.0)
    cols = np.arange(n)[None, :, None] + diffs
    cols[vals == 0.0] = 0
    cols_t = torch.from_numpy(cols.astype(np.int32)).to(cuda)
    vals_t = torch.from_numpy(vals).to(cuda)
    off_t = torch.from_numpy(vocab.astype(np.int32)).to(cuda)
    out = k3.ell_to_stencil(cols_t, vals_t, off_t)
    ref = k3.ell_to_stencil_plain(cols_t, vals_t, off_t)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _k3_inputs(l, n, r, s, seed, device, spread=None):
    """Rows of distinct vocabulary offsets (drawn from ±spread), dead slots
    and a few off-vocabulary entries, as test_k3_kernel_equals_plain makes."""
    gen = np.random.default_rng(seed)
    spread = spread or n - 1
    vocab = np.sort(gen.choice(np.arange(-spread, spread + 1), s, replace=False))
    k = min(r, s)
    diffs = np.zeros((l * n, r), np.int64)
    diffs[:, :k] = np.stack([gen.permutation(vocab)[:k] for _ in range(l * n)])
    vals = gen.normal(size=(l * n, r)).astype(np.float32)
    vals[:, k:] = 0.0
    vals[gen.random((l * n, r)) < 0.3] = 0.0
    stray = (gen.random((l * n, r)) < 0.03) & (vals != 0)
    diffs[stray] = spread + 1  # off the vocabulary
    cols = (np.arange(n)[None, :, None] + diffs.reshape(l, n, r)).astype(np.int32)
    return (torch.from_numpy(cols).to(device), torch.from_numpy(vals.reshape(l, n, r)).to(device),
            torch.from_numpy(vocab.astype(np.int32)).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("l,n,r,s,spread,tile", [
    (2, 1000, 5, 9, None, 32),           # N not a multiple of the tile, bulk copies
    (2, 1001, 3, 11, None, None),        # N * R odd: 4-byte copies
    (3, 777, 1, 5, None, None),          # one slot a row
    (1, 300, 3, 256, None, None),        # 256 offsets
    (1, 120, 200, 60, None, None),       # two chunks a tile
    (2, 5000, 9, 17, 12_000, None),      # span 24001: the binary search
    (5, 4099, 56, 41, 4004, None),       # the flagship's shape of row, a direct table
])
def test_k3_kernel_schedules_equal_plain(cuda, l, n, r, s, spread, tile):
    """The planner's schedule, the staged one at any R (cut to ``tile`` nodes
    where given) with the direct table and with the binary search, and the
    narrow-row one at any R."""
    cols, vals, offs = _k3_inputs(l, n, r, s, seed=n + r, device=cuda, spread=spread)
    ref = k3.ell_to_stencil_plain(cols, vals, offs)
    span = k3.offsets_span(offs)
    staged = k3.staged_plan(n, r, s, span)
    if tile is not None:
        staged = staged._replace(tile=tile, chunk=tile * r)
    assert staged.bulk == ((n * r) % 4 == 0)
    assert (staged.lookup > 0) == (span <= k3.MAX_LOOKUP_ENTRIES)
    narrow = k3.Plan(False, k3.NODE_THREADS, 0, False, 0)
    for sched in (k3.plan(n, r, s, span), staged, staged._replace(lookup=0), narrow):
        out = k3.ell_to_stencil_cuda(cols, vals, offs, schedule=sched)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), sched


def _gram_inputs(n, b, s, seed, device):
    w, offs = _random_stencil(n, s, seed=seed, big_offsets=True)
    offs_c = tuple(k1.center_offsets(offs, n).tolist())
    w = torch.from_numpy(w).to(device)
    w_shift = k1.shifted_weights(w, offs_c).contiguous()
    gen = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.rand(n, generator=gen, device=device) < 0.5).to(torch.float32)
    v = torch.randn((b, n), generator=gen, device=device)
    return w, w_shift, offs_c, tuple(-o for o in offs_c), mask, v


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 5, 16])
@pytest.mark.parametrize("n", [225, 1000, 4099])
def test_k2_kernels_match_plain(cuda, n, b):
    """N = 225 and 4099 leave a tail in the last block: its threads must add
    zero to the fused dot."""
    w, w_shift, offs, neg, mask, v = _gram_inputs(n, b, 9, seed=n + b, device=cuda)
    nv = torch.tensor([0.3], device=cuda)
    before = (k2.rmv_mask_launches, k2.mv_epilogue_launches)
    t = k2.rmv_mask_cuda(w_shift, mask, v, neg)
    out, dot = k2.mv_epilogue_cuda(w, t, mask, v, nv, offs)
    out2, dot2 = k2.mv_epilogue_cuda(w, k2.rmv_mask_cuda(w_shift, mask, v, neg), mask, v, nv, offs)
    torch.cuda.synchronize()
    assert (k2.rmv_mask_launches - before[0], k2.mv_epilogue_launches - before[1]) == (2, 2)
    t_ref = k2.rmv_mask_plain(w_shift, mask, v, neg)
    out_ref, dot_ref = k2.mv_epilogue_plain(w, t_ref, mask, v, nv, offs)
    for got, ref in ((t, t_ref), (out, out_ref)):
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    assert float(((dot - dot_ref).abs() / dot_ref.abs()).max()) <= 1e-5
    # no float atomics: a second launch gives the same bits
    assert torch.equal(out, out2) and torch.equal(dot, dot2)
    off_mask = mask == 0
    assert torch.equal(out[:, off_mask], v[:, off_mask])


def _k2_banded_check(w, v, offs, mask):
    """K2a and K2b on one case, two launches each: against the plain
    versions (relative 1e-5: fp32 sums of S terms, fma, another order; the
    dot N terms), bit-identical repeats, exact identity rows, and one partial
    per (row, block of BandPlan.tile(B) columns)."""
    b, n = v.shape
    neg = tuple(-o for o in offs)
    w_shift = k1.shifted_weights(w, offs).contiguous()
    nv = torch.tensor([0.3], device=v.device)
    before = (k2.rmv_mask_launches, k2.mv_epilogue_launches)
    t = k2.rmv_mask_cuda(w_shift, mask, v, neg)
    t2 = k2.rmv_mask_cuda(w_shift, mask, v, neg)
    out, part = k2.mv_epilogue_partials_cuda(w, t, mask, v, nv, offs)
    out2, part2 = k2.mv_epilogue_partials_cuda(w, t, mask, v, nv, offs)
    torch.cuda.synchronize()
    assert (k2.rmv_mask_launches - before[0], k2.mv_epilogue_launches - before[1]) == (2, 2)
    t_ref = k2.rmv_mask_plain(w_shift, mask, v, neg)
    out_ref, dot_ref = k2.mv_epilogue_plain(w, t, mask, v, nv, offs)
    assert _rel(t, t_ref) <= 1e-5
    assert _rel(out, out_ref) <= 1e-5
    assert float(((part.sum(dim=1) - dot_ref).abs() / dot_ref.abs()).max()) <= 1e-5
    assert part.shape == (b, -(-n // k1.BandPlan.tile(b)))
    assert torch.equal(t, t2) and torch.equal(out, out2) and torch.equal(part, part2)
    off_mask = mask == 0
    assert torch.equal(out[:, off_mask], v[:, off_mask])
    return t, out, part


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_K1_CASES))
def test_k2_banded_kernels_match_plain(cuda, name):
    """K2a and K2b on K1's cases: the seam inside a tile, N not a multiple
    of the tile (the tail adds zero to the partials), both copy widths,
    S = 256, N below one tile, the flagship's offsets at N = 1e6."""
    w, v, _, offs = _k1_case(name, cuda)
    gen = torch.Generator(device=cuda).manual_seed(v.shape[1])
    mask = (torch.rand(v.shape[1], generator=gen, device=cuda) < 0.5).to(torch.float32)
    _k2_banded_check(w, v, offs, mask)


@pytest.mark.gpu
@pytest.mark.parametrize("odd", ["v", "mask"])
def test_k2_kernels_take_unaligned_rows(cuda, odd):
    """A state or a mask that does not start on 16 bytes takes the 4-byte
    copies; N % 4 == 0 would otherwise pick 16."""
    w, v, _, offs = _k1_case("n4096-s41-b5", cuda)
    n = v.shape[1]
    mask = (torch.arange(n, device=cuda) % 3 == 0).to(torch.float32)
    x = v if odd == "v" else mask
    buf = torch.empty(x.numel() + 1, device=cuda)
    x_odd = buf[1:].view(x.shape)
    x_odd.copy_(x)
    assert x_odd.is_contiguous() and x_odd.data_ptr() % 16 != 0 and n % 4 == 0
    _k2_banded_check(w, x_odd if odd == "v" else v, offs, x_odd if odd == "mask" else mask)


@pytest.mark.gpu
def test_k2_dx_major_order_gives_the_sorted_bits(cuda):
    """The planner sorts: the flagship's offsets in dx-major order, with the
    weight rows in the same order, give the sorted order's t, out and
    partials bit for bit."""
    w, v, _, offs = _k1_case("flagship-b16", cuda)
    mask = torch.zeros(v.shape[1], device=cuda)
    mask[::2] = 1.0
    dx_major = [dx + 1000 * dy for dx in range(-4, 5) for dy in range(-4, 5)
                if abs(dx) + abs(dy) <= 4]
    rows = [offs.index(o) for o in dx_major]
    got = _k2_banded_check(w[rows].contiguous(), v, tuple(dx_major), mask)
    ref = _k2_banded_check(w, v, offs, mask)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gram_cg_kernel_matches_plain_and_repeats(cuda):
    n = 4099
    w, w_shift, offs, _, mask, v = _gram_inputs(n, 8, 7, seed=3, device=cuda)
    w = 0.3 * w  # keep the Gram operator's condition number modest

    class Phi:
        pass

    phi = Phi()
    phi.w, phi.w_shift, phi.offsets = w, k1.shifted_weights(w, offs), np.asarray(offs)
    b = v * mask[None, :]
    got = k2.gram_cg(phi, torch.tensor(0.5, device=cuda), mask, b, tol=0.0, max_iters=10)
    again = k2.gram_cg(phi, 0.5, mask, b, tol=0.0, max_iters=10)
    ref = k2.gram_cg_plain(phi, 0.5, mask, b, tol=0.0, max_iters=10)
    assert got.iterations == again.iterations == ref.iterations == 10
    assert torch.equal(got.x, again.x)
    # ten iterations amplify the products' 1e-7 differences a little
    assert float((got.x - ref.x).abs().max() / ref.x.abs().max()) <= 1e-4
    assert bool((got.x[:, mask == 0] == 0).all())


@pytest.mark.gpu
def test_cuda_wrappers_reject_bad_inputs(cuda):
    w = torch.randn(3, 100, device=cuda)
    with pytest.raises(ValueError):
        k1.stencil_matvec_cuda(w, torch.randn(17, 100, device=cuda), (0, 1, -1))
    with pytest.raises(ValueError):
        k1.stencil_matvec_cuda(w, torch.randn(100, 4, device=cuda).T, (0, 1, -1))
    with pytest.raises(ValueError):
        k1.stencil_matvec_cuda(w, torch.randn(2, 100), (0, 1, -1))
    with pytest.raises(ValueError):
        k1.stencil_matvec_cuda(w.double(), torch.randn(2, 100, device=cuda).double(), (0, 1, -1))
    mask = torch.ones(100, device=cuda)
    v = torch.randn(2, 100, device=cuda)
    with pytest.raises(ValueError):
        k2.rmv_mask_cuda(w, mask[:50], v, (0, 1, -1))
    with pytest.raises(ValueError):
        k2.rmv_mask_cuda(w, mask, torch.randn(17, 100, device=cuda), (0, 1, -1))
    with pytest.raises(ValueError):
        k2.mv_epilogue_cuda(w, v, mask, v[:1], torch.tensor([0.1], device=cuda), (0, 1, -1))
    with pytest.raises(ValueError):
        k2.mv_epilogue_cuda(w, v, mask, v, torch.tensor([0.1]), (0, 1, -1))
    with pytest.raises(ValueError):
        k3.ell_to_stencil_cuda(torch.zeros(1, 5, 2, dtype=torch.int64, device=cuda),
                               torch.zeros(1, 5, 2, device=cuda),
                               torch.zeros(1, dtype=torch.int32, device=cuda))


def _k4_check(graph, seed, cfg):
    before = k4.launches
    out = k4.sample_dense_step_matrices_cuda(graph, seed, cfg)
    again = k4.sample_dense_step_matrices_cuda(graph, seed, cfg)
    torch.cuda.synchronize()
    assert k4.launches - before == 2
    ref = k4.sample_dense_step_matrices_plain(graph, seed, cfg)
    n = graph.num_nodes
    assert out.shape == ref.shape == (cfg.max_walk_length, n, n)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 3e-5 * scale
    assert float((out - again).abs().max()) <= 1e-5 * scale  # atomics: summation order only
    assert torch.equal(out[0], torch.eye(n, device=out.device))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("ablation", [False, True])
@pytest.mark.parametrize("n,w,steps", [(64, 1, 5), (64, 50, 3), (225, 50, 10), (225, 1000, 4),
                                       (900, 1000, 10), (900, 1, 10), (4096, 50, 10)])
def test_k4_kernel_matches_plain(cuda, n, w, steps, ablation):
    adj = synthetic.generate("grid", n, seed=1)["adjacency"]
    graph = (pack_dense(adj.toarray()) if ablation else pack_laplacian(adj)).to(cuda)
    cfg = WalkConfig(walks_per_node=w, p_halt=0.05 if ablation else 0.1,
                     max_walk_length=steps, ablation=ablation)
    _k4_check(graph, 7 + n, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("n,steps", [(4096, 16), (4096, 30), (2500, 24)])
def test_k4_kernel_long_walks_take_several_passes(cuda, n, steps):
    """L·N floats above a block's 227 KB of shared memory, which once took
    several passes over the steps: the step matrices live in the output and
    the block's shared memory holds only the hash prefix, so one launch
    takes any walk length."""
    assert 4 * steps * n > k4.MAX_DYNAMIC_SMEM_BYTES
    graph = pack_laplacian(synthetic.generate("grid", n, seed=2)["adjacency"]).to(cuda)
    cfg = WalkConfig(walks_per_node=40, p_halt=0.02, max_walk_length=steps)
    _k4_check(graph, 11, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("n,w,threads", [(4096, 1000, None), (324, 1, None), (900, 33, 32),
                                         (900, 1000, 256)])
def test_k4_kernel_block_sizes_and_the_edge_of_the_regime(cuda, n, w, threads, monkeypatch):
    """N = 4096 at the planner's block; blocks of fewer threads than walks, so
    each thread walks several walks one after another (W = 33 on one warp,
    1000 on 256 threads)."""
    if threads is not None:
        monkeypatch.setattr(k4, "block_threads", lambda walks, cells: threads)
    graph = pack_laplacian(synthetic.generate("grid", n, seed=4)["adjacency"]).to(cuda)
    _k4_check(graph, 13, WalkConfig(walks_per_node=w, p_halt=0.1, max_walk_length=10))


@pytest.mark.gpu
def test_k4_kernel_isolated_node_and_er_graph(cuda):
    """A degree-0 row of the walked matrix halts at once: its rows are zero
    after step 0. (pack_dense of a raw adjacency, the ablation walk, keeps
    such a row; the Laplacian gives an isolated node a unit self-loop.)"""
    rng = np.random.default_rng(3)
    n = 97
    adj = np.triu((rng.random((n, n)) < 0.08).astype(np.float32), 1)
    adj = adj + adj.T
    adj[5, :] = adj[:, 5] = 0.0
    for ablation, graph in ((True, pack_dense(adj)), (False, pack_laplacian(adj))):
        cfg = WalkConfig(walks_per_node=33, p_halt=0.1, max_walk_length=6, ablation=ablation)
        out = _k4_check(graph.to(cuda), 5, cfg)
        if ablation:
            assert int(graph.degree[5]) == 0
            assert bool((out[1:, 5, :] == 0).all())


@pytest.mark.gpu
def test_k4_wrapper_rejects_bad_inputs(cuda):
    n = k4.MAX_NODES + 1
    big = PackedGraph(torch.zeros((n, 1), dtype=torch.int32, device=cuda),
                      torch.zeros((n, 1), device=cuda),
                      torch.zeros(n, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="supports N <= 4096"):
        k4.sample_dense_step_matrices_cuda(big, 0, WalkConfig(walks_per_node=8))
    graph = pack_laplacian(synthetic.generate("ring", 32)["adjacency"])
    with pytest.raises(ValueError, match="CUDA device"):
        k4.sample_dense_step_matrices_cuda(graph, 0, WalkConfig())
    g = graph.to(cuda)
    # ids outside the table are not refused (no pass over the graph, no wait
    # for the device): they end their walk, and the kernel stays in bounds
    stray = k4.sample_dense_step_matrices_cuda(
        PackedGraph(g.neighbors + 31, g.weights, g.degree + 7), 0, WalkConfig())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(stray).all()) and torch.equal(stray[0], torch.eye(32, device=cuda))
    with pytest.raises(ValueError, match="int32"):
        k4.sample_dense_step_matrices_cuda(
            PackedGraph(g.neighbors.long(), g.weights, g.degree), 0, WalkConfig())
    with pytest.raises(ValueError, match="walks_per_node"):
        k4.sample_dense_step_matrices_cuda(g, 0, WalkConfig(walks_per_node=0))
    assert k4.sample_dense_step_matrices_cuda(g, 0, WalkConfig(max_walk_length=0)).shape == (0, 32, 32)


# ---------------------------------------------------------------------------
# The CG loop on the train block as CUDA graphs of linalg.GRAPH_CHUNK
# iterations: the one-iteration loop's bits, one host read a replay; the
# other operators keep the one-iteration loop.
# ---------------------------------------------------------------------------


def _compact_fit_problem(device, layout="auto"):
    """A 20×20 grid's features, 30 observations padded to 48 slots with one
    repeated, and fixed probes for three Adam steps."""
    from graphgp_tpu_torch.preprocessor import preprocess_graph

    data = synthetic.generate("grid", 400, seed=0)
    feats = preprocess_graph(data["adjacency"], WalkConfig(64, 0.1, 3), seed=1, layout=layout,
                             device=device)
    rng = np.random.default_rng(0)
    idx = np.zeros(48, np.int64)
    idx[:30] = rng.choice(400, 30, replace=False)
    idx[5] = idx[3]
    mask = (np.arange(48) < 30).astype(np.float32)
    y = np.where(mask > 0, data["y_observed"][idx], 0.0).astype(np.float32)
    probes = torch.from_numpy(rng.choice([-1.0, 1.0], size=(3, 4, 48)).astype(np.float32))
    return feats, *(torch.from_numpy(a).to(device) for a in (idx, y, mask)), probes.to(device)


def _fit_counts(feats, idx, y, mask, probes):
    from graphgp_tpu_torch.gp import iterative
    from graphgp_tpu_torch.utils import profiling

    profiling.reset()
    profiling.enable()
    try:
        res = iterative.fit(
            feats, idx, y, mask=mask, num_steps=3, probes=probes,
            init={"raw_noise": torch.tensor(-1.5, device=idx.device),
                  "modulator": torch.tensor([1.0, 0.5, -0.3], device=idx.device)},
            settings=iterative.CGSettings(cg_tol=1e-2, cg_max_iters=100, num_probes=4,
                                          num_lanczos_iters=5))
        torch.cuda.synchronize()
        return res, profiling.snapshot()["counts"]
    finally:
        profiling.disable()
        profiling.reset()


@pytest.mark.gpu
def test_block_solves_run_as_cuda_graphs_with_the_eager_bits(cuda, monkeypatch):
    """A compact fit's solves (forward, and the adjoint and probe solves on
    autograd's thread) all replay CUDA graphs and give the fit of the
    one-iteration loop bit for bit; single solves on its block give that
    loop's x, residual and iterations and read the host at most once a
    replay and once more."""
    from graphgp_tpu_torch import linalg
    from graphgp_tpu_torch.gp import iterative
    from graphgp_tpu_torch.utils import profiling

    feats, idx, y, mask, probes = _compact_fit_problem(cuda)
    graphed, counts = _fit_counts(feats, idx, y, mask, probes)
    assert counts["cg.graph_solves"] == counts["cg.solves"] == 9
    assert 1 <= counts["cg.graph_captures"] <= 2  # B = 1 and the probes' B = 4
    with monkeypatch.context() as m:
        m.setattr(linalg, "_graphable", lambda *a: False)
        eager, eager_counts = _fit_counts(feats, idx, y, mask, probes)
    assert "cg.graph_solves" not in eager_counts
    assert eager_counts["cg.iterations"] == counts["cg.iterations"]
    assert counts["host.syncs"] < eager_counts["host.syncs"]
    assert torch.equal(graphed.losses, eager.losses)
    for name in eager.params:
        assert torch.equal(graphed.params[name], eager.params[name])

    block = iterative.build_train_block(feats, idx)
    f = torch.tensor([1.0, 0.5, -0.3], device=cuda)
    matvec = iterative.make_gram_matvec_block()
    rng = np.random.default_rng(1)
    for carry_mask, rows in ((mask, 1), (mask, 4), (None, 4), (mask, 16)):
        carry = (block.k_tt(f), torch.tensor(0.2, device=cuda), carry_mask)
        b = torch.from_numpy(rng.normal(size=(rows, 48)).astype(np.float32)).to(cuda)
        b = b[0] if rows == 1 else b
        ref = linalg._batched_cg_rows(matvec, carry, b, 1e-4, 100, None, None)
        profiling.reset()
        profiling.enable()
        try:
            got = linalg.batched_cg(matvec, carry, b, tol=1e-4, max_iters=100)
            c = profiling.snapshot()["counts"]
        finally:
            profiling.disable()
            profiling.reset()
        assert c["cg.graph_solves"] == c["cg.solves"] == 1
        assert got.iterations == ref.iterations > linalg.GRAPH_CHUNK
        assert torch.equal(got.x, ref.x) and torch.equal(got.residual_norm, ref.residual_norm)
        assert c["host.syncs"] <= -(-ref.iterations // linalg.GRAPH_CHUNK) + 1
        # a replay runs, and counts, a chunk's products
        assert c["gram.train_block"] == linalg.GRAPH_CHUNK * c["host.syncs"]


@pytest.mark.gpu
def test_k2_and_full_graph_solves_keep_the_one_iteration_loop(cuda):
    """K2's fused solve and the full-graph ELL Gram operator read the host
    every iteration as before: no CUDA graph."""
    from graphgp_tpu_torch.features import contract
    from graphgp_tpu_torch.gp import iterative
    from graphgp_tpu_torch.utils import profiling

    feats, idx, y, mask, _ = _compact_fit_problem(cuda, layout="ell")
    phi = contract(feats, torch.tensor([1.0, 0.5, -0.3], device=cuda))
    n = 4099
    w, _, offs, _, k2_mask, v = _gram_inputs(n, 8, 7, seed=3, device=cuda)

    class Phi:
        pass

    stencil = Phi()
    stencil.w, stencil.w_shift, stencil.offsets = 0.3 * w, k1.shifted_weights(0.3 * w, offs), \
        np.asarray(offs)
    profiling.reset()
    profiling.enable()
    try:
        full = iterative.batched_cg(iterative.make_gram_matvec_bm(),
                                    (phi, torch.tensor(0.2, device=cuda), idx, mask),
                                    y[None, :].repeat(4, 1), tol=1e-4, max_iters=100)
        fused = k2.gram_cg(stencil, 0.5, k2_mask, v * k2_mask[None, :], tol=1e-4, max_iters=20)
        c = profiling.snapshot()["counts"]
    finally:
        profiling.disable()
        profiling.reset()
    assert "cg.graph_solves" not in c and "cg.graph_captures" not in c
    assert c["cg.solves"] == 1
    assert c["cg.iterations"] == full.iterations + fused.iterations
    # one read an iteration, and one more where a solve converged before its cap
    assert c["host.syncs"] == sum(r.iterations + (r.iterations < cap)
                                  for r, cap in ((full, 100), (fused, 20)))
