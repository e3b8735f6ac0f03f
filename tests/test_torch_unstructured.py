"""The layouts of unstructured graphs against the JAX package: CSR walks, the
ELL products with their analytic transposes, the column-sorted transpose,
ContractedFeatures through ``mll_cg``, the ``.csc.npz`` sidecar and the
kernel constructors' routing of CSR graphs.

The graph is skewed on purpose: a star of 150 leaves joined to an Erdős–Rényi
graph of 200 nodes, whose ELL padding is far above the 4x at which
``pack_laplacian`` takes the CSR layout. Walks, packed tables and the
transpose are integer work and copies: exact. Products differ from the JAX
package's only in float32 summation order: within 1e-5 of max |ref|; the
solves of ``mll_cg`` amplify that a little: rtol 1e-4, as in
``test_torch_gp.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphgp_tpu import features as jfeat
from graphgp_tpu import graphs as jgraphs
from graphgp_tpu import kernels as jkernels
from graphgp_tpu import linalg as jlin
from graphgp_tpu import walker as jwalker
from graphgp_tpu.gp import iterative as jit_
from graphgp_tpu.preprocessor import preprocess_graph as jax_preprocess
from graphgp_tpu_torch import features as tfeat
from graphgp_tpu_torch import graphs as tgraphs
from graphgp_tpu_torch import kernels as tkernels
from graphgp_tpu_torch import walker as twalker
from graphgp_tpu_torch.convert import dense_from_numpy, ell_features_from_jax, params_from_jax
from graphgp_tpu_torch.cuda_kernels import walker as k_walker
from graphgp_tpu_torch.gp import iterative as tit
from graphgp_tpu_torch.preprocessor import preprocess_graph as torch_preprocess

REL = 1e-5  # of max |ref|: float32 sums in another order
RTOL = 1e-4  # through the solves of mll_cg
CPU = {"device": "cpu"}


def star_er(n_er=200, leaves=150, p=0.03, seed=0) -> sp.csr_matrix:
    """A hub joined to ``leaves`` nodes of an Erdős–Rényi graph of ``n_er``
    nodes (plus one more node, the hub)."""
    rng = np.random.default_rng(seed)
    n = n_er + 1
    a = np.triu((rng.random((n, n)) < p).astype(np.float64), 1)
    a[0, 1 : leaves + 1] = 1.0
    a = a + a.T
    for i in range(n):  # no isolated nodes
        if a[i].sum() == 0:
            a[i, (i + 1) % n] = a[(i + 1) % n, i] = 1.0
    return sp.csr_matrix(a)


@pytest.fixture(scope="module")
def adj():
    return star_er()


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= rel * scale, float(np.abs(got - ref).max()) / scale


def _jax_ell(adj, cfg, seed):
    log = jwalker.sample_walk_log(jgraphs.pack_laplacian(adj), jax.random.PRNGKey(seed), cfg)
    return jfeat.consolidate(log, jfeat.suggest_row_capacity(log),
                             walks_per_node=cfg.walks_per_node)


@pytest.fixture(scope="module")
def pair(adj):
    """One ELL operator and its transpose, in both packages."""
    cfg = jwalker.WalkConfig(32, 0.1, 4)
    jm = _jax_ell(adj, cfg, seed=3)
    jcsc = jfeat.transpose_ell(jm)
    jf = jfeat.EllFeatures(jm, jcsc)
    tf = ell_features_from_jax(np.asarray(jm.cols), np.asarray(jm.vals), jm.num_target_nodes, jcsc)
    return jf, tf


def _draws(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


F = np.asarray([1.0, -0.6, 0.35, 0.2], np.float32)


# ---------------------------------------------------------------------------
# Packing and walks
# ---------------------------------------------------------------------------


def test_skewed_graph_packs_as_csr_like_jax(adj):
    jg = jgraphs.pack_laplacian(adj)
    tg = tgraphs.pack_laplacian(adj)
    assert isinstance(jg, jgraphs.CsrGraph) and isinstance(tg, tgraphs.CsrGraph)
    np.testing.assert_array_equal(tg.node_table.numpy(), np.asarray(jg.node_table))
    edge = np.asarray(jg.edge_table)
    np.testing.assert_array_equal(tg.neighbors.numpy(), edge[:, 0].astype(np.int32))
    np.testing.assert_array_equal(tg.weights.numpy(), edge[:, 1])
    assert tg.num_nodes == jg.num_nodes and tg.nnz == jg.nnz
    np.testing.assert_array_equal(tg.degree.numpy(), np.asarray(jg.degree))
    assert tg.to("cpu").device == torch.device("cpu")


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_pack_csr_layout_forced_matches_jax(adj, dense):
    a = adj.toarray() if dense else star_er(60, 20, 0.1, seed=1)
    jg = jgraphs.pack_laplacian(a, layout="csr")
    tg = tgraphs.pack_laplacian(a, layout="csr")
    np.testing.assert_array_equal(tg.node_table.numpy(), np.asarray(jg.node_table))
    np.testing.assert_array_equal(tg.neighbors.numpy(), np.asarray(jg.edge_table)[:, 0])
    w_ref = np.asarray(jg.edge_table)[:, 1]
    if dense:  # XLA's CPU rsqrt is not correctly rounded: within two ulps
        np.testing.assert_allclose(tg.weights.numpy(), w_ref, rtol=3e-7, atol=0)
    else:
        np.testing.assert_array_equal(tg.weights.numpy(), w_ref)


def test_pack_auto_keeps_ell_below_the_padding_threshold():
    ring = sp.diags([np.ones(63), np.ones(63)], [1, -1], shape=(64, 64)).tocsr()
    assert isinstance(tgraphs.pack_laplacian(ring), tgraphs.PackedGraph)
    assert isinstance(jgraphs.pack_laplacian(ring), jgraphs.PackedGraph)
    with pytest.raises(ValueError, match="unknown layout"):
        tgraphs.pack_laplacian(ring, layout="coo")


def test_csr_graph_refuses_2_pow_24_nodes():
    big = sp.csr_matrix((1 << 24, 1 << 24), dtype=np.float64)
    with pytest.raises(ValueError, match="2\\^24"):
        tgraphs.csr_graph(big)


@pytest.mark.parametrize(
    "wpn,p_halt,length,offset,count,ablation",
    [
        (16, 0.1, 5, 0, None, False),
        (7, 0.3, 6, 0, None, False),
        (33, 0.05, 3, 17, 64, False),
        (16, 0.1, 4, 0, None, True),
        (1, 0.0, 8, 190, 11, False),
    ],
)
def test_csr_walks_bit_identical_to_jax(adj, wpn, p_halt, length, offset, count, ablation):
    cfg = dict(walks_per_node=wpn, p_halt=p_halt, max_walk_length=length, ablation=ablation)
    ref = jwalker.sample_walk_log(jgraphs.pack_laplacian(adj), jax.random.PRNGKey(5),
                                  jwalker.WalkConfig(**cfg), node_offset=offset,
                                  num_start_nodes=count)
    got = twalker.sample_walk_log(tgraphs.pack_laplacian(adj), 5, twalker.WalkConfig(**cfg),
                                  node_offset=offset, num_start_nodes=count)
    np.testing.assert_array_equal(got.curs.numpy(), np.asarray(ref.curs))
    np.testing.assert_array_equal(got.loads.numpy(), np.asarray(ref.loads))


def test_csr_walks_equal_ell_walks(adj):
    """The two layouts hold one graph: the same walks."""
    cfg = twalker.WalkConfig(12, 0.1, 5)
    a = twalker.sample_walk_log(tgraphs.pack_laplacian(adj, layout="csr"), 9, cfg)
    b = twalker.sample_walk_log(tgraphs.pack_laplacian(adj, layout="ell"), 9, cfg)
    np.testing.assert_array_equal(a.curs.numpy(), b.curs.numpy())
    np.testing.assert_array_equal(a.loads.numpy(), b.loads.numpy())


def test_blocked_pipeline_on_csr_matches_monolithic(adj):
    from graphgp_tpu_torch.pipeline import blocked_ell_features

    cfg = twalker.WalkConfig(16, 0.1, 4)
    g = tgraphs.pack_laplacian(adj)
    log = twalker.sample_walk_log(g, 2, cfg)
    mono = tfeat.consolidate(log, tfeat.suggest_row_capacity(log), walks_per_node=16)
    blocked = blocked_ell_features(g, 2, cfg, block_size=48, capacity=mono.row_capacity,
                                   **CPU).mats
    np.testing.assert_array_equal(blocked.cols.numpy(), mono.cols.numpy())
    np.testing.assert_array_equal(blocked.vals.numpy(), mono.vals.numpy())


# ---------------------------------------------------------------------------
# The column-sorted transpose
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg,seed", [((32, 0.1, 4), 3), ((8, 0.2, 3), 0), ((200, 0.1, 5), 1)],
                         ids=["w32", "w8", "w200"])
def test_transpose_ell_equals_jax(adj, cfg, seed):
    jm = _jax_ell(adj, jwalker.WalkConfig(*cfg), seed)
    jcsc = jfeat.transpose_ell(jm)
    tm = ell_features_from_jax(np.asarray(jm.cols), np.asarray(jm.vals), jm.num_target_nodes).mats
    tcsc = tfeat.transpose_ell(tm)
    for name in ("rows", "vals", "seg_start", "last_pos", "has_any"):
        got, ref = getattr(tcsc, name).numpy(), np.asarray(getattr(jcsc, name))
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert tcsc.vrow_chunk == jcsc.vrow_chunk


def test_vrow_pointers_bound_each_column(pair):
    _, tf = pair
    csc = tf.csc
    ptr = csc.vrow_ptr.numpy()
    seg = csc.seg_start.reshape(csc.max_walk_length, -1).numpy()
    last, has = csc.last_pos.numpy(), csc.has_any.numpy()
    for l in range(csc.max_walk_length):
        for c in np.flatnonzero(has[l]):
            assert seg[l, ptr[l, c]] and ptr[l, c + 1] == last[l, c] + 1
        assert (ptr[l, 1:][~has[l]] == ptr[l, :-1][~has[l]]).all()  # empty columns
        assert csc.used_vrows[l] == ptr[l, -1]


def test_segmented_sum_scan_matches_jax():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, 300)).astype(np.float32)
    starts = rng.random(300) < 0.1
    starts[0] = True
    ref = np.asarray(jfeat.segmented_sum_scan(jnp.asarray(z), jnp.asarray(starts)))
    got = tfeat.segmented_sum_scan(torch.from_numpy(z), torch.from_numpy(starts)).numpy()
    _close(got, ref)
    basic = tfeat.segmented_sum_scan(torch.tensor([1.0, 2, 3, 4, 5, 6]),
                                     torch.tensor([True, False, True, False, False, True]))
    np.testing.assert_allclose(basic.numpy(), [1.0, 3.0, 3.0, 7.0, 12.0, 6.0])


def test_with_transpose_attaches_once(pair):
    _, tf = pair
    plain = tfeat.EllFeatures(tf.mats)
    fast = tfeat.with_transpose(plain)
    assert fast.csc is not None and tfeat.with_transpose(fast) is fast


# ---------------------------------------------------------------------------
# Products and their transposes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 5, 17])
def test_ell_matvec_bm_matches_jax(pair, b):
    jf, tf = pair
    v = _draws((b, tf.num_target_nodes), b)
    ref = jfeat.ell_phi_matvec_bm(jf.mats, jnp.asarray(F), jnp.asarray(v))
    _close(tfeat.ell_phi_matvec_bm(tf.mats, torch.from_numpy(F), torch.from_numpy(v)), ref)
    _close(tf.matvec_bm(torch.from_numpy(F), torch.from_numpy(v)), ref)


@pytest.mark.parametrize("b", [1, 5, 17])
def test_ell_rmatvec_bm_scatter_and_csc_match_jax(pair, b):
    jf, tf = pair
    v = _draws((b, tf.num_nodes), 10 + b)
    ref = jfeat.ell_phi_rmatvec_bm(jf.mats, jnp.asarray(F), jnp.asarray(v))
    _close(jfeat.csc_phi_rmatvec_bm(jf.csc, jnp.asarray(F), jnp.asarray(v)), ref)
    ft, vt = torch.from_numpy(F), torch.from_numpy(v)
    _close(tfeat.ell_phi_rmatvec_bm(tf.mats, ft, vt), ref)
    _close(tfeat.csc_phi_rmatvec_bm(tf.csc, ft, vt), ref)
    _close(tf.rmatvec_bm(ft, vt), ref)
    _close(tfeat.EllFeatures(tf.mats).rmatvec_bm(ft, vt), ref)


def test_csc_rmatvec_single_vector_matches_jax(pair):
    jf, tf = pair
    v = _draws((tf.num_nodes,), 4)
    ref = jfeat.csc_phi_rmatvec(jf.csc, jnp.asarray(F), jnp.asarray(v))
    _close(tfeat.csc_phi_rmatvec(tf.csc, torch.from_numpy(F), torch.from_numpy(v)), ref)


@pytest.mark.parametrize("which", ["matvec", "rmatvec"])
@pytest.mark.parametrize("shape", ["vector", "columns"])
def test_column_major_products_match_jax(pair, which, shape):
    jf, tf = pair
    size = (tf.num_nodes,) if shape == "vector" else (tf.num_nodes, 3)
    v = _draws(size, 21)
    ref = getattr(jf, which)(jnp.asarray(F), jnp.asarray(v))
    _close(getattr(tf, which)(torch.from_numpy(F), torch.from_numpy(v)), ref)


def test_ell_rows_match_jax(pair):
    jf, tf = pair
    idx = np.asarray([0, 3, 3, 57, 200], np.int32)
    ref = jfeat.ell_phi_rows(jf.mats, jnp.asarray(F), jnp.asarray(idx))
    _close(tf.rows(torch.from_numpy(F), torch.from_numpy(idx)), ref)


def test_products_repeat_bit_for_bit(pair):
    _, tf = pair
    v = torch.from_numpy(_draws((9, tf.num_nodes), 2))
    f = torch.from_numpy(F)
    assert torch.equal(tf.matvec_bm(f, v), tf.matvec_bm(f, v))
    assert torch.equal(tf.rmatvec_bm(f, v), tf.rmatvec_bm(f, v))


def test_products_agree_with_dense_reconstruction(pair):
    _, tf = pair
    phi = torch.einsum("l,lij->ij", torch.from_numpy(F), tfeat.ell_to_dense(tf.mats)).double()
    v = torch.from_numpy(_draws((4, tf.num_nodes), 8))
    f = torch.from_numpy(F)
    _close(tf.matvec_bm(f, v), (v.double() @ phi.T).numpy())
    _close(tf.rmatvec_bm(f, v), (v.double() @ phi).numpy())


@pytest.mark.parametrize("which", ["matvec_bm", "rmatvec_bm"])
@pytest.mark.parametrize("layout", ["csc", "scatter"])
def test_product_vjps_match_jax(pair, which, layout):
    """Gradients of both products with respect to f and v against ``jax.vjp``
    of the JAX package's custom VJPs."""
    jf, tf = pair
    if layout == "scatter":
        jf, tf = jfeat.EllFeatures(jf.mats), tfeat.EllFeatures(tf.mats)
    b, n = 3, tf.num_nodes
    v, g = _draws((b, n), 30), _draws((b, n), 31)
    out_j, vjp = jax.vjp(lambda f, x: getattr(jf, which)(f, x), jnp.asarray(F), jnp.asarray(v))
    df_j, dv_j = vjp(jnp.asarray(g))
    f = torch.from_numpy(F.copy()).requires_grad_(True)
    x = torch.from_numpy(v).requires_grad_(True)
    out = getattr(tf, which)(f, x)
    _close(out.detach(), out_j)
    out.backward(torch.from_numpy(g))
    _close(f.grad, df_j)
    _close(x.grad, dv_j)


def test_gradient_through_step_matrix_values_raises(pair):
    _, tf = pair
    f = torch.from_numpy(F)
    v = torch.from_numpy(_draws((2, tf.num_nodes), 1))
    vals = tf.mats.vals.clone().requires_grad_(True)
    bad = tfeat.EllFeatures(tfeat.EllStepMatrices(tf.mats.cols, vals, tf.num_target_nodes), tf.csc)
    for op in (bad.matvec_bm, bad.rmatvec_bm):
        with pytest.raises(ValueError, match="step-matrix values"):
            op(f, v)
    csc_vals = tf.csc.vals.clone().requires_grad_(True)
    bad_csc = tfeat.EllFeatures(tf.mats, tfeat.CscStepMatrices(
        tf.csc.rows, csc_vals, tf.csc.seg_start, tf.csc.last_pos, tf.csc.has_any))
    with pytest.raises(ValueError, match="step-matrix values"):
        bad_csc.rmatvec_bm(f, v)
    with torch.no_grad():  # no gradient asked for: the products run
        bad.matvec_bm(f, v)


# ---------------------------------------------------------------------------
# ContractedFeatures and the GP
# ---------------------------------------------------------------------------


def test_contract_binds_ell_and_dense_layouts(pair):
    _, tf = pair
    f = torch.from_numpy(F)
    c = tfeat.contract(tf, f)
    assert isinstance(c, tfeat.ContractedFeatures) and c.feats is tf
    assert c.num_nodes == tf.num_nodes and c.num_target_nodes == tf.num_target_nodes
    v = torch.from_numpy(_draws((2, tf.num_nodes), 3))
    assert torch.equal(c.matvec_bm(v), tf.matvec_bm(f, v))
    assert torch.equal(c.rmatvec_bm(v), tf.rmatvec_bm(f, v))
    with pytest.raises(TypeError, match="no feature layout"):
        tfeat.contract(object(), f)


def test_contract_on_dense_features_matches_jax(pair):
    jf, _ = pair
    dense = np.asarray(jfeat.ell_to_dense(jf.mats))
    jd = jfeat.contract(jfeat.DenseFeatures(jnp.asarray(dense)), jnp.asarray(F))
    td = tfeat.contract(dense_from_numpy(dense), torch.from_numpy(F))
    assert isinstance(td, tfeat.ContractedFeatures)
    v = _draws((3, dense.shape[1]), 5)
    _close(td.matvec_bm(torch.from_numpy(v)), jd.matvec_bm(jnp.asarray(v)))
    _close(td.rmatvec_bm(torch.from_numpy(v)), jd.rmatvec_bm(jnp.asarray(v)))
    idx = np.asarray([1, 7, 7], np.int32)
    _close(td.rows(torch.from_numpy(idx)), jd.rows(jnp.asarray(idx)))


def _padded_obs(n_nodes, n_real=30, cap=48, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.zeros(cap, np.int32)
    idx[:n_real] = rng.choice(n_nodes, n_real, replace=False)
    idx[5] = idx[3]
    y = np.zeros(cap, np.float32)
    y[:n_real] = rng.normal(size=n_real)
    mask = (np.arange(cap) < n_real).astype(np.float32)
    return idx, y, mask


SETTINGS = dict(cg_tol=1e-6, cg_max_iters=300, num_probes=8, num_lanczos_iters=10)


@pytest.mark.parametrize("layout", ["csc", "scatter", "dense"])
def test_mll_cg_value_and_modulator_gradient_match_jax(pair, layout):
    """The modulator's gradient reaches it through the solves' adjoints on the
    contracted ELL (and dense) layout, and equals JAX's."""
    jf, tf = pair
    if layout == "scatter":
        jf, tf = jfeat.EllFeatures(jf.mats), tfeat.EllFeatures(tf.mats)
    elif layout == "dense":
        dense = np.asarray(jfeat.ell_to_dense(jf.mats))
        jf, tf = jfeat.DenseFeatures(jnp.asarray(dense)), dense_from_numpy(dense)
    idx, y, mask = _padded_obs(tf.num_nodes)
    p0 = {"raw_noise": np.float32(-1.2), "modulator": np.asarray([1.0, 0.5, -0.3, 0.2], np.float32)}
    key = jax.random.PRNGKey(4)
    js = jit_.CGSettings(**SETTINGS)

    def neg_mll(p):
        return -jit_.mll_cg(jf, p, jnp.asarray(idx), jnp.asarray(y), key, kind="free",
                            settings=js, mask=jnp.asarray(mask), num_real=jnp.float32(30))

    val_j, g_j = jax.value_and_grad(neg_mll)({k: jnp.asarray(v) for k, v in p0.items()})
    probes = np.asarray(jlin.rademacher_probes(key, idx.size, js.num_probes)).T.copy()
    p = {k: v.requires_grad_(True) for k, v in params_from_jax(p0).items()}
    val = -tit.mll_cg(tf, p, torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(y),
                      settings=tit.CGSettings(**SETTINGS), mask=torch.from_numpy(mask),
                      num_real=30.0, probes=torch.from_numpy(probes))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(val_j), rtol=RTOL)
    for k in p0:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(g_j[k]), rtol=RTOL, atol=1e-4)
    assert torch.all(p["modulator"].grad != 0)


# The train block on the ELL layout against the full-graph products (the
# forward ELL product and the column-sorted transpose) it replaces in the
# fits: float32 summation order alone, REL on one product, RTOL through the
# solves of mll_cg, as test_torch_gp.py's stencil cases.


def _ell_slots(n_nodes, masked, seed=0):
    """Masked: padded slots repeat node 0 with y 0, one observation repeats
    another. Unmasked: 30 slots with one repeated observation."""
    if masked:
        idx, y, mask = _padded_obs(n_nodes, seed=seed)
        return torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(y), torch.from_numpy(mask)
    rng = np.random.default_rng(seed)
    idx = rng.choice(n_nodes, 30, replace=False)
    idx[5] = idx[3]
    return torch.from_numpy(idx), torch.from_numpy(_draws(30, seed)), None


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_train_block_gram_matvec_on_ell_equals_full_graph(pair, masked):
    _, tf = pair
    assert tf.csc is not None
    idx, _, mask = _ell_slots(tf.num_nodes, masked)
    f, nv = torch.from_numpy(F), torch.tensor(0.2)
    v = torch.from_numpy(_draws((5, idx.numel()), 7))
    block = tit.build_train_block(tf, idx)
    got = tit.make_gram_matvec_block()((block.k_tt(f), nv, mask), v)
    phi = tfeat.contract(tf, f)
    ref = tit.make_gram_matvec_bm()((phi, nv, idx, mask), v)
    _close(got, ref)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_mll_cg_on_the_ell_train_block_equals_full_graph(pair, masked, monkeypatch):
    _, tf = pair
    idx, y, mask = _ell_slots(tf.num_nodes, masked, seed=1)
    probes = torch.from_numpy(np.sign(_draws((8, idx.numel()), 2)))
    settings = tit.CGSettings(**SETTINGS)

    def run():
        p = {"raw_noise": torch.tensor(-1.2, requires_grad=True),
             "modulator": torch.from_numpy(F.copy()).requires_grad_(True)}
        val = tit.mll_cg(tf, p, idx, y, settings=settings, mask=mask,
                         num_real=None if mask is None else float(mask.sum()), probes=probes)
        val.backward()
        return val.detach(), {k: v.grad for k, v in p.items()}

    assert tit.build_train_block(tf, idx) is not None
    val, grads = run()
    monkeypatch.setattr(tit, "TRAIN_BLOCK_BUDGET", 0)
    ref_val, ref_grads = run()
    np.testing.assert_allclose(float(val), float(ref_val), rtol=RTOL)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), ref_grads[k].numpy(), rtol=RTOL, atol=1e-4)
    assert torch.all(grads["modulator"] != 0)


def test_two_ell_train_block_builds_are_bit_identical(pair):
    _, tf = pair
    idx, _, _ = _ell_slots(tf.num_nodes, True)
    a, b = tit.build_train_block(tf, idx), tit.build_train_block(tf, idx)
    assert a.gram.shape == (4, idx.numel(), 4, idx.numel())
    assert torch.equal(a.gram, b.gram)


@pytest.fixture(scope="module")
def rgg_pair():
    """A 600-node random geometric graph (the port's generator) as ELL
    features with their transpose, in both packages."""
    from graphgp_tpu_torch.data import synthetic

    g = synthetic.generate("rgg", 600, seed=3)["adjacency"]
    jm = _jax_ell(g, jwalker.WalkConfig(32, 0.1, 4), seed=5)
    jcsc = jfeat.transpose_ell(jm)
    tf = ell_features_from_jax(np.asarray(jm.cols), np.asarray(jm.vals), jm.num_target_nodes, jcsc)
    return jfeat.EllFeatures(jm, jcsc), tf


def _dense_gram(feats, idx):
    """``G[l, a, m, b]`` in float64 from every slot's dense train rows."""
    cols, vals = tfeat.step_rows(feats, idx)
    l, t, _ = vals.shape
    rows = np.zeros((l, t, feats.num_target_nodes))
    np.add.at(rows, (np.arange(l)[:, None, None], np.arange(t)[None, :, None], cols.numpy()),
              vals.double().numpy())
    rows = rows.reshape(l * t, -1)
    return torch.from_numpy(rows @ rows.T).view(l, t, l, t)


@pytest.mark.parametrize("slots", ["padded", "node_0_live", "unmasked"])
@pytest.mark.parametrize("graph", ["skewed", "rgg"])
def test_the_sparse_ell_block_equals_a_float64_dense_gram(pair, rgg_pair, graph, slots):
    """Padded slots at node 0 (and a live observation of node 0 among
    them), a repeated live node, or no padding."""
    tf = (pair if graph == "skewed" else rgg_pair)[1]
    idx, _, _ = _ell_slots(tf.num_nodes, slots != "unmasked")
    if slots == "node_0_live":
        idx[7] = 0
    got = tit.build_train_block(tf, idx).gram.double()
    ref = _dense_gram(tf, idx)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_two_rgg_train_block_builds_are_bit_identical(rgg_pair):
    _, tf = rgg_pair
    idx, _, _ = _ell_slots(tf.num_nodes, True)
    a, b = tit.build_train_block(tf, idx), tit.build_train_block(tf, idx)
    assert torch.equal(a.gram, b.gram)


def test_mll_cg_on_the_rgg_block_matches_the_full_graph_and_jax(rgg_pair, monkeypatch):
    jf, tf = rgg_pair
    idx, y, mask = _padded_obs(tf.num_nodes, seed=4)
    p0 = {"raw_noise": np.float32(-1.2), "modulator": F.copy()}
    key = jax.random.PRNGKey(6)
    js = jit_.CGSettings(**SETTINGS)

    def neg_mll(p):
        return -jit_.mll_cg(jf, p, jnp.asarray(idx), jnp.asarray(y), key, kind="free",
                            settings=js, mask=jnp.asarray(mask), num_real=jnp.float32(30))

    val_j, g_j = jax.value_and_grad(neg_mll)({k: jnp.asarray(v) for k, v in p0.items()})
    probes = torch.from_numpy(np.asarray(jlin.rademacher_probes(key, idx.size,
                                                                js.num_probes)).T.copy())
    t_idx = torch.from_numpy(idx.astype(np.int64))

    def run():
        p = {k: v.requires_grad_(True) for k, v in params_from_jax(p0).items()}
        val = -tit.mll_cg(tf, p, t_idx, torch.from_numpy(y), settings=tit.CGSettings(**SETTINGS),
                          mask=torch.from_numpy(mask), num_real=30.0, probes=probes)
        val.backward()
        return val.detach(), {k: v.grad for k, v in p.items()}

    assert tit.build_train_block(tf, t_idx) is not None
    val, grads = run()
    monkeypatch.setattr(tit, "TRAIN_BLOCK_BUDGET", 0)
    ref_val, ref_grads = run()
    for v in (ref_val, val_j):
        np.testing.assert_allclose(float(val), float(v), rtol=RTOL)
    for k in p0:
        for g in (ref_grads[k].numpy(), np.asarray(g_j[k])):
            np.testing.assert_allclose(grads[k].numpy(), g, rtol=RTOL, atol=1e-4)
    assert torch.all(grads["modulator"] != 0)


def test_dense_features_take_the_full_graph_path(pair, monkeypatch):
    jf, _ = pair
    dense = dense_from_numpy(np.asarray(jfeat.ell_to_dense(jf.mats)))
    idx, y, mask = _ell_slots(dense.num_nodes, True)
    assert tit.build_train_block(dense, idx) is None
    calls = []
    monkeypatch.setattr(tit, "make_gram_matvec_block", lambda: calls.append(1))
    tit.mll_cg(dense, {"raw_noise": torch.tensor(-1.2), "modulator": torch.from_numpy(F)}, idx, y,
               settings=tit.CGSettings(**SETTINGS), mask=mask, num_real=30.0,
               generator=torch.Generator().manual_seed(0))
    assert calls == []



# The draws' compact residual solve on the ELL train block against the same
# draw on the forward ELL and column-sorted transposed products (the budget
# at 0 refuses every block), as test_torch_gp.py's stencil cases: the same
# CG iterations or one apart, each solve at its true float64 residual, and
# converged draws within REL of the largest sample.

P_DRAW = {"raw_noise": np.float32(-1.2), "modulator": F}


def _recorded_draw(feats, idx, y, mask, tol=1e-2):
    """A pathwise draw at every node under fixed ε; the recorder's counts
    inside its ``gp.predict`` span; and its solve, ``(b, CGResult)``."""
    from graphgp_tpu_torch.utils import profiling

    eps1 = torch.from_numpy(_draws((4, feats.num_target_nodes), 5))
    eps2 = torch.from_numpy(_draws((4, idx.numel()), 6))
    solves, original = [], tit.batched_cg

    def captured(matvec, carry, b, **kwargs):
        out = original(matvec, carry, b, **kwargs)
        solves.append((b, out))
        return out

    tit.batched_cg = captured
    profiling.reset()
    profiling.enable()
    try:
        out = tit.pathwise_predict(
            feats, params_from_jax(P_DRAW), idx, y, torch.arange(feats.num_nodes),
            num_samples=4, settings=tit.CGSettings(cg_tol=tol, cg_max_iters=300), mask=mask,
            eps1=eps1, eps2=eps2)
        (predict,) = [s for s in profiling.snapshot()["spans"] if s["name"] == "gp.predict"]
    finally:
        tit.batched_cg = original
        profiling.disable()
        profiling.reset()
    (solve,) = solves
    return out, predict["counts"], solve


def _true_residual(feats, idx, mask, solve):
    """‖b − Ã x‖ / ‖b‖ of a draw's compact solve in float64, Ã the masked
    operator from every slot's dense train rows (repeated slots add up)."""
    from graphgp_tpu_torch.gp import params as tparams

    b, res = solve
    p = params_from_jax(P_DRAW)
    f = tparams.modulator("free", p, feats.max_walk_length).double()
    k = torch.einsum("l,lamb,m->ab", f, _dense_gram(feats, idx), f)
    m = torch.ones(idx.numel(), dtype=torch.float64) if mask is None else mask.double()
    a = m[:, None] * k * m[None, :] + torch.diag(
        float(tparams.noise_variance(p)) * m + (1 - m))
    b = b.double()
    return torch.linalg.vector_norm(b - res.x.double() @ a, dim=-1) / \
        torch.linalg.vector_norm(b, dim=-1)


@pytest.mark.parametrize("tol", [1e-2, 1e-6])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("graph", ["skewed", "rgg"])
def test_a_draw_on_the_ell_train_block_equals_the_full_graph_draw(pair, rgg_pair, graph, masked,
                                                                 tol, monkeypatch):
    """Padded slots at node 0 and a repeated train node (masked), or a
    repeated node alone, on the star-and-ER graph and a random geometric
    graph."""
    tf = (pair if graph == "skewed" else rgg_pair)[1]
    idx, y, mask = _ell_slots(tf.num_nodes, masked, seed=2)
    got, on_block, block_solve = _recorded_draw(tf, idx, y, mask, tol)
    assert on_block["gram.train_block"] > 0 and "gram.full_graph" not in on_block
    monkeypatch.setattr(tit, "TRAIN_BLOCK_BUDGET", 0)
    ref, on_graph, graph_solve = _recorded_draw(tf, idx, y, mask, tol)
    assert on_graph["gram.full_graph"] > 0 and "gram.train_block" not in on_graph
    assert abs(on_block["cg.iterations"] - on_graph["cg.iterations"]) <= 1
    for solve in (block_solve, graph_solve):
        drift = _true_residual(tf, idx, mask, solve) - solve[1].residual_norm.double()
        assert float(drift.abs().max()) <= 1e-5
    if tol <= 1e-6:
        _close(got, ref)


def test_a_dense_layout_draw_takes_the_full_graph_path(pair):
    """Dense features have no train rows to build a block from: every Gram
    product of the draw's solve is a full-graph one: one an iteration, none
    at the solve's zero start."""
    jf, _ = pair
    dense = dense_from_numpy(np.asarray(jfeat.ell_to_dense(jf.mats)))
    idx, y, mask = _ell_slots(dense.num_nodes, True)
    _, counts, _ = _recorded_draw(dense, idx, y, mask)
    assert counts["gram.full_graph"] == counts["cg.iterations"]
    assert "gram.train_block" not in counts

def test_pathwise_predict_on_ell_matches_jax_given_same_draws(pair):
    jf, tf = pair
    idx, y, mask = _padded_obs(tf.num_nodes, seed=2)
    p0 = {"raw_noise": np.float32(-1.0), "modulator": np.asarray([1.0, 0.4, 0.2, 0.1], np.float32)}
    test_idx = np.arange(tf.num_nodes, dtype=np.int32)
    key = jax.random.PRNGKey(6)
    js = jit_.CGSettings(cg_tol=1e-6, cg_max_iters=300)
    ref = jit_.pathwise_predict(jf, {k: jnp.asarray(v) for k, v in p0.items()}, jnp.asarray(idx),
                                jnp.asarray(y), jnp.asarray(test_idx), key, kind="free",
                                num_samples=3, settings=js, mask=jnp.asarray(mask))
    k1, k2 = jax.random.split(key)
    eps1 = np.asarray(jax.random.normal(k1, (tf.num_target_nodes, 3))).T.copy()
    eps2 = np.asarray(jax.random.normal(k2, (idx.size, 3))).T.copy()
    got = tit.pathwise_predict(
        tf, params_from_jax(p0), torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(y),
        torch.from_numpy(test_idx.astype(np.int64)), num_samples=3,
        settings=tit.CGSettings(cg_tol=1e-6, cg_max_iters=300), mask=torch.from_numpy(mask),
        eps1=torch.from_numpy(eps1), eps2=torch.from_numpy(eps2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-4)


def test_full_space_prediction_on_ell_equals_compact(pair):
    """Distinct train ids: the full-space solve (batched CG on this layout)
    and the compact one give the same posterior samples."""
    _, tf = pair
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.choice(tf.num_nodes, 40, replace=False).astype(np.int64))
    y = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    p = params_from_jax({"raw_noise": np.float32(-1.0), "modulator": F})
    eps1 = torch.from_numpy(_draws((2, tf.num_target_nodes), 3))
    eps2 = torch.from_numpy(_draws((2, 40), 4))
    s = tit.CGSettings(cg_tol=1e-7, cg_max_iters=400)
    kw = dict(num_samples=2, settings=s, eps1=eps1, eps2=eps2)
    test = torch.arange(tf.num_nodes)
    full = tit.pathwise_predict(tf, p, idx, y, test, full_space=True, **kw)
    compact = tit.pathwise_predict(tf, p, idx, y, test, **kw)
    _close(full, compact, rel=1e-4)


# ---------------------------------------------------------------------------
# The preprocessor, the sidecar and the kernel constructors
# ---------------------------------------------------------------------------


def test_preprocess_auto_attaches_transpose_like_jax(adj):
    cfg = dict(walks_per_node=16, p_halt=0.1, max_walk_length=3)
    jfeats = jax_preprocess(adj, jwalker.WalkConfig(**cfg), seed=4, layout="auto")
    trace = {}
    tfeats = torch_preprocess(adj, twalker.WalkConfig(**cfg), seed=4, layout="auto",
                              trace=trace, **CPU)
    assert isinstance(tfeats, tfeat.EllFeatures) and tfeats.csc is not None
    assert {"walk_consolidate_s", "vocabulary_s", "transpose_s"} <= set(trace)
    np.testing.assert_array_equal(tfeats.mats.cols.numpy(), np.asarray(jfeats.mats.cols))
    for name in ("rows", "seg_start", "last_pos", "has_any"):
        np.testing.assert_array_equal(getattr(tfeats.csc, name).numpy(),
                                      np.asarray(getattr(jfeats.csc, name)), err_msg=name)
    _close(tfeats.csc.vals, jfeats.csc.vals)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_csc_sidecar_reads_across_packages(adj, tmp_path, writer):
    """The ``.csc.npz`` sidecar written by either package loads in the other
    (the ELL cache beside it too) and gives the same operator."""
    cfg = dict(walks_per_node=16, p_halt=0.1, max_walk_length=3)
    cache = str(tmp_path)
    if writer == "jax":
        first = jax_preprocess(adj, jwalker.WalkConfig(**cfg), seed=1, cache_dir=cache,
                               layout="auto")
        second = torch_preprocess(adj, twalker.WalkConfig(**cfg), seed=1, cache_dir=cache,
                                  layout="auto", **CPU)
        jf, tf = first, second
    else:
        first = torch_preprocess(adj, twalker.WalkConfig(**cfg), seed=1, cache_dir=cache,
                                 layout="auto", **CPU)
        second = jax_preprocess(adj, jwalker.WalkConfig(**cfg), seed=1, cache_dir=cache,
                                layout="auto")
        jf, tf = second, first
    sidecars = sorted(p.name for p in tmp_path.glob("*.csc.npz"))
    assert len(sidecars) == 1
    with np.load(tmp_path / sidecars[0]) as z:
        assert sorted(z.files) == ["has_any", "last_pos", "rows", "seg_start", "vals"]
        assert [z[k].dtype for k in ("rows", "vals", "seg_start", "last_pos", "has_any")] == [
            np.int32, np.float32, np.bool_, np.int32, np.bool_]
    assert isinstance(second, (tfeat.EllFeatures, jfeat.EllFeatures)) and second.csc is not None
    v = _draws((2, tf.num_nodes), 0)
    f = np.asarray([1.0, 0.5, 0.25], np.float32)
    _close(tf.rmatvec_bm(torch.from_numpy(f), torch.from_numpy(v)),
           jf.rmatvec_bm(jnp.asarray(f), jnp.asarray(v)))
    # a second torch call reads the sidecar, not the walks
    again = torch_preprocess(adj, twalker.WalkConfig(**cfg), seed=1, cache_dir=cache,
                             layout="auto", **CPU)
    assert torch.equal(again.csc.rows, tf.csc.rows)


def test_features_for_adjacency_unstructured_large_graph_returns_ell_with_transpose(adj):
    feats = tkernels.features_for_adjacency(adj, 0, walks_per_node=16, max_walk_length=3,
                                            dense_bytes_limit=1, **CPU)
    assert isinstance(feats, tfeat.EllFeatures) and feats.csc is not None
    ref = jkernels.features_for_adjacency(adj, jax.random.PRNGKey(0), walks_per_node=16,
                                          max_walk_length=3, dense_bytes_limit=1)
    np.testing.assert_array_equal(feats.mats.cols.numpy(), np.asarray(ref.mats.cols))
    np.testing.assert_array_equal(feats.csc.rows.numpy(), np.asarray(ref.csc.rows))


def test_step_matrices_for_csr_graph_never_reach_k4(adj, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("K4 was called for a CSR graph")

    monkeypatch.setattr(k_walker, "sample_dense_step_matrices_cuda", refuse)
    got = tkernels.step_matrices_for_adjacency(adj, 2, walks_per_node=16, max_walk_length=3,
                                               **CPU)
    ref = jkernels.step_matrices_for_adjacency(adj, jax.random.PRNGKey(2), walks_per_node=16,
                                               max_walk_length=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_k4_wrapper_refuses_a_csr_graph(adj):
    with pytest.raises(ValueError, match="CsrGraph"):
        k_walker.sample_dense_step_matrices_cuda(tgraphs.pack_laplacian(adj), 0,
                                                 twalker.WalkConfig(4, 0.1, 3))
