"""K4 (fused walks → dense step matrices) as csrc/walker.cu computes it, on
the CPU: the packed (neighbour, degree, weight) table against the
PackedGraph it is made from; the launch planner (the hash prefix in shared
memory, the threads of a block); and a numpy emulation of the kernel's walk
order (a block per start node clearing its rows of the output and writing
the identity row; each thread walking walk t, then t + threads, ... as its
walks end; the three phases of a round; the records of steps 1 and 2
summed among a warp's lanes on the same cell;
every record added into the output row of its step; the rows divided by W
at the end), whose walks are bit-identical to ``walker.sample_walk_log`` and
whose matrices agree with the plain version. The CUDA kernel itself is
tested on the card by test_torch_cuda_kernels.py.

Tolerance: the walks are compared bit for bit. The matrices differ from the
plain version in the order of the float32 additions and in one rounding (the
sum divided by W once, where the plain version adds fl(load / W)): 3e-5 of
max |ref|, the tolerance chip_smoke.py holds the kernel to (REL_TOL_K4).
"""
import numpy as np
import pytest
import torch

from graphgp_tpu_torch.cuda_kernels import walker as k4
from graphgp_tpu_torch.graphs import PackedGraph, pack_dense, pack_laplacian
from graphgp_tpu_torch.walker import WalkConfig, _mix, hash_words, key_words, sample_walk_log

REL_TOL = 3e-5
AGG_STEPS = 2  # csrc/walker.cu: kAggSteps
F32 = np.float32


def _grid(side, drop=()):
    n = side * side
    adj = np.zeros((n, n), np.float32)
    for r in range(side):
        for c in range(side):
            i = r * side + c
            if r + 1 < side:
                adj[i, i + side] = adj[i + side, i] = 1
            if c + 1 < side:
                adj[i, i + 1] = adj[i + 1, i] = 1
    for i in drop:  # isolated nodes
        adj[i, :] = adj[:, i] = 0
    return adj


def _uniform(bits):
    return F32(bits >> 8) * F32(2.0**-24)


def _emulate(graph, seed, cfg, threads=32):
    """(M, records): the kernel's (L, N, N) output and, per start node, the
    records {(walk, step): (cur, load)} its threads made. The lanes of a warp
    go round together, so the lanes on one cell in a round sum their loads."""
    table = k4.packed_table_plain(graph).numpy().view(np.uint32)
    degree = graph.degree.numpy()
    n, d = graph.neighbors.shape
    w_total, steps = cfg.walks_per_node, cfg.max_walk_length
    k0, k1 = key_words(seed)
    p_halt, inv_keep = F32(cfg.p_halt), F32(1.0 / (1.0 - cfg.p_halt))
    out = np.full((steps, n, n), np.nan, F32)
    records = {}
    for node in range(n):
        rows = np.zeros((steps, n), F32)  # the block clears its rows
        rows[0, node] = 1.0
        prefix = [_mix(hash_words(k0, k1, word) ^ node) for word in range(2 * steps)]
        deg0 = max(0, min(int(degree[node]), d))
        for warp in range(threads // 32):
            lanes = range(32 * warp, 32 * warp + 32)
            walk = {t: t for t in lanes}
            state = {t: [0, node, deg0, F32(1.0)] for t in lanes}  # step, cur, deg, load
            while any(walk[t] < w_total for t in lanes):
                moves = {}
                for t in lanes:  # 1. halt tests, picks and table loads
                    moves[t] = None
                    if walk[t] >= w_total:
                        continue
                    l, cur, deg, _ = state[t]
                    if l == steps - 1:
                        continue
                    u_halt = _uniform(_mix(prefix[2 * l] ^ walk[t]))
                    if deg <= 0 or u_halt < p_halt:
                        continue
                    u_pick = _uniform(_mix(prefix[2 * l + 1] ^ walk[t]))
                    pick = min(int(u_pick * F32(deg)), deg - 1)
                    moves[t] = table[cur, pick]
                live = [t for t in lanes if walk[t] < w_total and state[t][0] > 0]
                for t in live:  # 2. the records
                    l, cur, _, load = state[t]
                    records.setdefault(node, {})[walk[t], l] = (cur, load)
                    if l > AGG_STEPS:
                        rows[l, cur] += load
                        continue
                    peers = [u for u in live if state[u][:2] == [l, cur]]
                    if t == peers[0]:  # the lowest lane adds the lanes' sum
                        total = load
                        for u in peers[1:]:
                            total = F32(total + state[u][3])
                        rows[l, cur] += total
                for t, nxt in moves.items():  # 3. transitions
                    if walk[t] >= w_total:
                        continue
                    l, cur, deg, load = state[t]
                    if nxt is not None and nxt[0] & 0xFFFF != 0xFFFF:
                        wgt = nxt[1:].view(np.float32)[0]
                        if not cfg.ablation:
                            wgt = F32(F32(F32(load * F32(deg)) * wgt) * inv_keep)
                        state[t] = [l + 1, int(nxt[0] & 0xFFFF), int(nxt[0] >> 16), wgt]
                    else:
                        walk[t] += threads
                        state[t] = [0, node, deg0, F32(1.0)]
        rows[1:] /= F32(w_total)
        out[:, node] = rows
    return out, records


def _check(graph, seed, cfg, **kw):
    steps = cfg.max_walk_length
    got, records = _emulate(graph, seed, cfg, **kw)
    log = sample_walk_log(graph, seed, cfg)
    curs, loads = log.curs.numpy(), log.loads.numpy()
    for node in range(graph.num_nodes):  # every live record of steps >= 1, and nothing else
        want = {(w, l): (int(curs[l, node, w]), loads[l, node, w])
                for l in range(1, steps) for w in range(cfg.walks_per_node)
                if loads[l, node, w] != 0}
        seen = records.get(node, {})
        assert seen.keys() == want.keys(), node
        for key, (cur, load) in want.items():
            assert seen[key][0] == cur and seen[key][1].tobytes() == load.tobytes(), (node, key)
    ref = k4.sample_dense_step_matrices_plain(graph, seed, cfg).numpy()
    np.testing.assert_array_equal(got[0], np.eye(graph.num_nodes, dtype=np.float32))
    assert np.abs(got - ref).max() <= REL_TOL * np.abs(ref).max()
    return got


@pytest.mark.parametrize("threads", [32, 64])
@pytest.mark.parametrize("ablation", [False, True])
def test_emulated_walks_match_the_walk_log(threads, ablation):
    adj = _grid(4)
    graph = pack_dense(adj) if ablation else pack_laplacian(adj)
    _check(graph, 3, WalkConfig(walks_per_node=16, p_halt=0.1, max_walk_length=5,
                                ablation=ablation), threads=threads)


@pytest.mark.parametrize("wpn,p_halt", [(16, 0.05), (40, 0.05), (64, 0.3), (33, 0.0)])
def test_emulated_warp_sums_of_the_early_steps(wpn, p_halt):
    """Records of steps 1 and 2 are summed among the lanes on one cell and
    added once; later ones are added one by one. Either way the same sums,
    with walks crowding the early cells (p_halt 0: every walk runs to L)."""
    _check(pack_laplacian(_grid(5)), 8, WalkConfig(wpn, p_halt, 6))


def test_emulated_threads_take_the_next_walk():
    """W = 70 on 32 threads: lanes 0-5 run a third walk after their first
    walks end (walk t, t + 32, t + 64); with 64 threads the second warp's
    lanes 0-5 take walks 64-69; with 96 threads, walks 70-95 are never run."""
    graph = pack_laplacian(_grid(3))
    for threads in (32, 64, 96):
        _check(graph, 5, WalkConfig(70, 0.2, 4), threads=threads)


@pytest.mark.parametrize("steps", [1, 2, 12])
def test_emulated_walk_lengths(steps):
    """L = 1 is the identity alone; long walks need no passes, since the step
    matrices live in the output."""
    got = _check(pack_laplacian(_grid(3)), 6, WalkConfig(10, 0.02, steps))
    assert got.shape == (steps, 9, 9)


def test_emulated_isolated_nodes_and_stray_ids_end_walks():
    """Degree 0 halts at once; a neighbour id outside [0, N) ends the walk
    before it is recorded (the packed entry reads 0xFFFF)."""
    adj = _grid(4, drop=(5,))
    graph = pack_dense(adj)
    assert int(graph.degree[5]) == 0
    cfg = WalkConfig(9, 0.1, 4, ablation=True)
    m = _check(graph, 2, cfg)
    assert (m[1:, 5, :] == 0).all()
    nb = graph.neighbors.clone()
    nb[0, 0] = 16  # the first neighbour of node 0 lies outside the table
    nb[3, 1] = -2
    stray = PackedGraph(nb, graph.weights, graph.degree)
    table = k4.packed_table_plain(stray).numpy().view(np.uint32)
    assert table[0, 0, 0] == table[3, 1, 0] == 0xFFFF
    got, records = _emulate(stray, 2, cfg)
    assert all(cur < 16 for rec in records.values() for cur, _ in rec.values())
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], np.eye(16, dtype=np.float32))


def test_packed_table_against_the_graph():
    rng = np.random.default_rng(0)
    adj = (rng.random((40, 40)) < 0.1).astype(np.float32)
    adj = np.triu(adj, 1)
    adj = adj + adj.T
    adj[7, :] = adj[:, 7] = 0.0
    for graph in (pack_dense(adj), pack_laplacian(adj)):
        n, d = graph.neighbors.shape
        table = k4.packed_table_plain(graph)
        assert table.shape == (n, d, 2) and table.dtype == torch.int32
        word = table[..., 0].numpy().view(np.uint32)
        nb, deg = graph.neighbors.numpy(), graph.degree.numpy()
        np.testing.assert_array_equal(word & 0xFFFF, nb)
        np.testing.assert_array_equal(word >> 16, np.clip(deg[nb], 0, d))
        np.testing.assert_array_equal(table[..., 1].view(torch.float32).numpy(),
                                      graph.weights.numpy())
    # degrees past the row width are cut to it, negative ones to 0
    odd = PackedGraph(torch.tensor([[1, 2], [0, 9], [2, 1]], dtype=torch.int32),
                      torch.ones(3, 2), torch.tensor([2, 70_000, -3], dtype=torch.int32))
    word = k4.packed_table_plain(odd)[..., 0].numpy().view(np.uint32)
    np.testing.assert_array_equal(word, [[1 | 2 << 16, 2], [0 | 2 << 16, 0xFFFF],
                                         [2, 1 | 2 << 16]])


@pytest.mark.parametrize("n,steps", [(321, 10), (900, 10), (4096, 10), (4096, 16), (64, 500)])
def test_planner_blocks_and_shared_memory(n, steps):
    assert k4.shared_memory_bytes(steps) == 8 * steps <= k4.MAX_DYNAMIC_SMEM_BYTES
    for wpn in (1, 64, 1000, 8192):
        threads = k4.block_threads(wpn, steps * n)
        assert threads % 32 == 0 and 32 <= threads <= k4.MAX_THREADS
        assert threads >= min(wpn, k4.MAX_THREADS - 31)
