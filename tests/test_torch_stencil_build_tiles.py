"""K3 (ELL → stencil) as csrc/stencil_build.cu computes it: a numpy emulation
of the kernel's two schedules from ``stencil_build.plan``, held against the
plain version and against the JAX package's Pallas kernel in interpret mode.
The staged schedule: persistent blocks over (step, tile) pairs, each tile's
slab cut into chunks staged one at a time by bulk copies only where every
chunk starts and ends on 16 bytes, threads on consecutive entries with the
kernel's running node and slot, the slot from the direct table or the
branch-free lower bound over the offsets, the padded (S, tile + 1) tile
written out and cleared after a tile's last chunk. The narrow-row schedule:
a thread a node, its own column of the tile. The CUDA kernel itself is
tested on the card by test_torch_cuda_kernels.py.

Tolerance: none. A consolidated row holds distinct live columns, so every
output cell receives at most one entry and all three agree bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgp_tpu.pallas_kernels.stencil_build import ell_to_stencil_pallas
from graphgp_tpu_torch.cuda_kernels import stencil_build as k3


def _ell(l, n, r, s, seed, stray=0.05, dead=0.3):
    """(cols, vals, offsets): rows of distinct vocabulary offsets, slots past
    min(R, S) and dead slots (val 0) holding column ids that would match a
    vocabulary offset, and a few live entries off the vocabulary."""
    gen = np.random.default_rng(seed)
    vocab = np.sort(gen.choice(np.arange(-n + 1, n), s, replace=False))
    k = min(r, s)
    diffs = np.zeros((l * n, r), np.int64)
    diffs[:, :k] = np.stack([gen.permutation(vocab)[:k] for _ in range(l * n)])
    diffs[:, k:] = vocab[0]  # dead padding that would hit slot 0 if it were live
    vals = gen.normal(size=(l * n, r)).astype(np.float32)
    vals[:, k:] = 0.0
    vals[gen.random((l * n, r)) < dead] = 0.0
    off_vocab = np.setdiff1d(np.arange(-n + 1, n), vocab)
    if off_vocab.size:
        hit = (gen.random((l * n, r)) < stray) & (vals != 0)
        diffs[hit] = gen.choice(off_vocab, int(hit.sum()))
    cols = (np.arange(n)[None, :, None] + diffs.reshape(l, n, r)).astype(np.int32)
    return cols, vals.reshape(l, n, r), vocab.astype(np.int32)


def _slot(offs, d, top):
    """The kernel's branch-free lower bound: the slot of offset d, or -1."""
    pos, h = 0, top
    while h > 0:
        if pos + h <= offs.size and offs[pos + h - 1] < d:
            pos += h
        h >>= 1
    return pos if pos < offs.size and offs[pos] == d else -1


def _emulate(cols, vals, offs, sched, blocks):
    """The staged schedule's arithmetic, block by block; returns the output
    and how many times each output element was written."""
    l, n, r = cols.shape
    s = offs.size
    assert sched.staged
    tile, chunk = sched.tile, sched.chunk
    flat_c, flat_v = cols.reshape(-1), vals.reshape(-1)
    per_step = -(-n // tile)
    chunks = sched.chunks(r)
    assert blocks <= l * per_step
    row = tile + 1
    top = 1 << (s.bit_length() - 1)
    off_lo, off_hi = int(offs[0]), int(offs[-1])
    direct = off_hi - off_lo < sched.lookup
    slot_of = np.zeros(sched.lookup, np.int64)
    if direct:
        slot_of[offs - off_lo] = np.arange(1, s + 1)
    out = np.full((l, s, n), np.nan, np.float32)
    writes = np.zeros((l, s, n), np.int64)
    assert sched.smem_bytes(s) <= k3.MAX_DYNAMIC_SMEM_BYTES
    for b in range(blocks):
        acc = np.zeros(s * row, np.float32)
        my_chunks = (l * per_step - b + blocks - 1) // blocks * chunks

        def chunk_of(q):
            t = b + (q // chunks) * blocks
            c = q % chunks
            step, i0 = t // per_step, (t % per_step) * tile
            nodes = min(tile, n - i0)
            length = max(0, min(chunk, nodes * r - c * chunk))
            return step, c, i0, nodes, length, (step * n + i0) * r + c * chunk

        staged = 0 if my_chunks else None  # the chunk in the buffer
        for q in range(my_chunks):
            step, c, i0, nodes, length, src = chunk_of(q)
            assert staged == q  # issued when chunk q - 1 was read
            if sched.bulk:  # one bulk copy of cols and one of vals: 16-byte ends
                assert src % 4 == 0 and length % 4 == 0
            staged_c, staged_v = flat_c[src:src + length], flat_v[src:src + length]
            for t in range(k3.THREADS):
                first = c * chunk + t
                node, slot = first // r, first % r
                for e in range(t, length, k3.THREADS):
                    assert (node, slot) == divmod(c * chunk + e, r)
                    x = staged_v[e]
                    d = int(staged_c[e]) - (i0 + node)
                    if x != 0.0 and off_lo <= d <= off_hi:
                        pos = slot_of[d - off_lo] - 1 if direct else _slot(offs, d, top)
                        if pos >= 0:
                            acc[pos * row + node] += x
                    node += k3.THREADS // r
                    slot += k3.THREADS % r
                    if slot >= r:
                        slot -= r
                        node += 1
            staged = q + 1
            if c == chunks - 1:
                cells = acc.reshape(s, row)[:, :nodes]
                out[step, :, i0:i0 + nodes] = cells
                writes[step, :, i0:i0 + nodes] += 1
                cells[...] = 0.0
        assert not acc.any()
    return out, writes


def _emulate_rows(cols, vals, offs):
    """The narrow-row schedule: a block of 128 threads per (step, 128 nodes),
    a thread reading its node's slots in order into its own column."""
    l, n, r = cols.shape
    s = offs.size
    top = 1 << (s.bit_length() - 1)
    out = np.full((l, s, n), np.nan, np.float32)
    writes = np.zeros((l, s, n), np.int64)
    assert k3.Plan(False, k3.NODE_THREADS, 0, False, 0).smem_bytes(s) <= k3.MAX_DYNAMIC_SMEM_BYTES
    for step in range(l):
        for i0 in range(0, n, k3.NODE_THREADS):
            acc = np.zeros((s, k3.NODE_THREADS), np.float32)
            for t in range(min(k3.NODE_THREADS, n - i0)):
                for slot in range(r):
                    x = vals[step, i0 + t, slot]
                    if x != 0.0:
                        pos = _slot(offs, int(cols[step, i0 + t, slot]) - (i0 + t), top)
                        if pos >= 0:
                            acc[pos, t] += x
            nodes = min(k3.NODE_THREADS, n - i0)
            out[step, :, i0:i0 + nodes] = acc[:, :nodes]
            writes[step, :, i0:i0 + nodes] += 1
    return out, writes


def _staged(n, r, offs, tile=None):
    """The staged schedule the planner gives wide rows, for any R; with a
    ``tile``, cut to that tile and one chunk a tile."""
    sched = k3.staged_plan(n, r, offs.size, k3.offsets_span(torch.from_numpy(offs)))
    if tile is None:
        return sched
    chunk = tile * r
    return sched._replace(tile=tile, chunk=chunk, bulk=sched.bulk and chunk % 4 == 0)


def _narrow(n, r, offs):
    """The planner's schedule for these rows had their offsets spanned more
    columns than a direct slot table takes."""
    sched = k3.plan(n, r, offs.size, k3.MAX_LOOKUP_ENTRIES + 1)
    assert not sched.staged
    return sched


def _check(cols, vals, offs, sched, blocks, pallas=True):
    if sched.staged:
        out, writes = _emulate(cols, vals, offs, sched, blocks)
    else:
        out, writes = _emulate_rows(cols, vals, offs)
    assert (writes == 1).all()
    ref = k3.ell_to_stencil_plain(torch.from_numpy(cols), torch.from_numpy(vals),
                                  torch.from_numpy(offs)).numpy()
    np.testing.assert_array_equal(out, ref)
    if pallas:
        want = ell_to_stencil_pallas(jnp.asarray(cols), jnp.asarray(vals),
                                     tuple(int(o) for o in offs), interpret=True)
        np.testing.assert_array_equal(out, np.asarray(want))
    return out


@pytest.mark.parametrize("blocks", [1, 3, 7])
@pytest.mark.parametrize("r", [5, 9, 12, 16])
def test_emulated_tiles_n_not_a_multiple_of_the_tile(r, blocks):
    """N = 100 over 32-node tiles: the last tile of each step holds 4 nodes,
    and blocks take (step, tile) pairs gridDim apart."""
    cols, vals, offs = _ell(2, 100, r, 9, seed=r)
    sched = _staged(100, r, offs, tile=32)
    assert sched.bulk and sched.chunks(r) == 1 and sched.lookup == offs[-1] - offs[0] + 1
    _check(cols, vals, offs, sched, blocks, pallas=(r, blocks) == (9, 3))
    _check(cols, vals, offs, sched._replace(lookup=0), blocks, pallas=False)


@pytest.mark.parametrize("n,r", [(101, 3), (99, 5), (13, 7)])
def test_emulated_tiles_unaligned_slabs_take_4_byte_copies(n, r):
    """N·R not a multiple of 4: slabs start and end off 16 bytes, so the plan
    stages by cp.async, and the schedule is otherwise the same; the
    narrow-row schedule reads the same rows in place."""
    assert (n * r) % 4 != 0
    cols, vals, offs = _ell(2, n, r, 11, seed=n)
    sched = _staged(n, r, offs, tile=32)
    assert not sched.bulk
    _check(cols, vals, offs, sched, blocks=2)
    _check(cols, vals, offs, _narrow(n, r, offs), blocks=1, pallas=False)


def test_emulated_tiles_one_slot_per_row():
    cols, vals, offs = _ell(3, 70, 1, 5, seed=2)
    sched = _staged(70, 1, offs, tile=32)
    assert sched.chunk == 32 and sched.bulk is False  # 70 · 1 % 4 != 0
    _check(cols, vals, offs, sched, blocks=4)
    cols, vals, offs = _ell(1, 72, 1, 5, seed=3)
    aligned = _staged(72, 1, offs)
    assert aligned.bulk and aligned.tile == k3.MAX_TILE
    _check(cols, vals, offs, aligned, blocks=1)


def test_emulated_tiles_256_offsets():
    """S = 256, the most the kernel takes: a 64-node tile keeps the
    accumulator at 66.5 KB, and the lower bound takes nine halvings."""
    cols, vals, offs = _ell(1, 129, 3, 256, seed=4)
    sched = _staged(129, 3, offs)
    assert sched.tile == 64 and not sched.bulk and sched.lookup > 0
    _check(cols, vals, offs, sched, blocks=2)
    _check(cols, vals, offs, sched._replace(lookup=0), blocks=2, pallas=False)
    _check(cols, vals, offs, _narrow(129, 3, offs), blocks=1, pallas=False)


def test_emulated_tiles_wide_rows_take_several_chunks():
    """R = 200: a 32-node slab is 6400 entries, so each tile is staged in two
    chunks (4096 and 2304 entries) and written out after the second."""
    cols, vals, offs = _ell(1, 40, 200, 60, seed=5, dead=0.5)
    sched = k3.plan(40, 200, 60, k3.offsets_span(torch.from_numpy(offs)))
    assert (sched.staged, sched.tile, sched.chunk, sched.chunks(200)) == (True, 32, 4096, 2)
    assert sched.bulk
    _check(cols, vals, offs, sched, blocks=2, pallas=False)
    _check(cols, vals, offs, sched, blocks=1, pallas=False)


def test_emulated_tiles_dead_slots_only():
    cols, vals, offs = _ell(2, 64, 4, 7, seed=6)
    vals[:] = 0.0
    out = _check(cols, vals, offs, _staged(64, 4, offs, tile=32), blocks=3)
    assert not out.any()
    assert not _check(cols, vals, offs, _narrow(64, 4, offs), blocks=1, pallas=False).any()


@pytest.mark.parametrize("n,r", [(300, 1), (129, 8), (1000, 4), (130, 7)])
def test_emulated_narrow_rows_one_thread_a_node(n, r):
    """Narrow rows: a block of 128 threads a node each; N not a multiple of
    128, dead slots and off-vocabulary entries."""
    cols, vals, offs = _ell(2, n, r, 13, seed=r)
    sched = _narrow(n, r, offs)
    assert sched == k3.Plan(False, k3.NODE_THREADS, 0, False, 0)
    _check(cols, vals, offs, sched, blocks=1, pallas=n < 200)


@pytest.mark.parametrize("n,r,s,span,want", [
    (10**6, 56, 41, 8001, (True, 64, 3584, True, 8001)),   # the flagship's ELL: a 28 KB stage
    (2**20, 8, 9, 2**21 - 1, (False, 128, 0, False, 0)),   # the ring at L = 3: narrow rows
    (2**20, 8, 25, 25, (True, 512, 4096, True, 25)),       # narrow rows with a direct table
    (2**20, 9, 9, 2**21 - 1, (True, 256, 2304, True, 0)),  # 9 slots: staged, searched
    (1000, 56, 41, 161, (True, 64, 3584, True, 161)),
    (1001, 56, 41, 161, (True, 64, 3584, True, 161)),      # 1001 · 56 is a multiple of 4
    (1001, 9, 17, 1999, (True, 256, 2304, False, 1999)),
    (129, 9, 256, 257, (True, 64, 576, False, 257)),
    (100, 5000, 41, 16384, (True, 32, 4096, True, 16384)),  # 40 chunks of a tile
    (100, 5000, 41, 16385, (True, 32, 4096, True, 0)),
])
def test_plan_fits_shared_memory(n, r, s, span, want):
    sched = k3.plan(n, r, s, span)
    assert (sched.staged, sched.tile, sched.chunk, sched.bulk, sched.lookup) == want
    assert sched.staged == (r > k3.NARROW_ROW_SLOTS or span <= k3.MAX_LOOKUP_ENTRIES)
    assert sched.smem_bytes(s) <= k3.MAX_DYNAMIC_SMEM_BYTES
    assert not k3.plan(n, r, s, span, aligned=False).bulk
    if sched.staged:
        assert sched.tile & (sched.tile - 1) == 0 and k3.MIN_TILE <= sched.tile <= k3.MAX_TILE
        assert sched.chunk <= min(sched.tile * r, k3.STAGE_ENTRIES)


def test_plan_every_shape_fits_shared_memory():
    for s in (1, 9, 41, 100, 256):
        for r in (1, 3, 8, 9, 56, 128, 129, 4096, 100_000):
            for sched in (k3.plan(1000, r, s, k3.MAX_LOOKUP_ENTRIES),
                          k3.staged_plan(1000, r, s, k3.MAX_LOOKUP_ENTRIES)):
                assert sched.smem_bytes(s) <= k3.MAX_DYNAMIC_SMEM_BYTES, (r, s)


def test_offsets_span():
    assert k3.offsets_span(torch.tensor([-1000, -1, 0, 1, 1000], dtype=torch.int32)) == 2001
    assert k3.offsets_span(torch.tensor([7], dtype=torch.int32)) == 1
    assert k3.offsets_span(torch.zeros(0, dtype=torch.int32)) == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    cols, vals, offs = _ell(1, 16, 2, 3, seed=7)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k3.ell_to_stencil_cuda(torch.from_numpy(cols), torch.from_numpy(vals),
                               torch.from_numpy(offs))
    assert k3.launches == 0
