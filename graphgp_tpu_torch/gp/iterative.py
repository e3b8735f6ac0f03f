"""Large-N GP inference: CG marginal likelihood and pathwise conditioning.

Counterpart of ``graphgp_tpu/gp/iterative.py``. A fit solves at its train
slots t with a dense ``K_tt = Φ_t Φ_tᵀ`` formed from a train block
(:class:`TrainBlock`): Φ is linear in the modulator, ``Φ = Σ_l f_l M_l``,
so ``K_tt = Σ_{l,m} f_l f_m G_lm`` with ``G_lm = M_l[t,:] M_m[t,:]ᵀ``,
built once per fit from the train rows of each step matrix. A draw's
compact residual solve builds the block of its own train slots the same
way. Where no block applies (layouts other than stencil and ELL, full-space
solves, a block over :data:`TRAIN_BLOCK_BUDGET`), the Gram matvec is
composed from full-graph Φ products of a contracted operator
(``features.contract``), so no N×N matrix ever exists:

    K_tt v = (Φ (Φᵀ expand(v)))[train]

and every Φ product of a stencil layout is kernel K1. The full-space
prediction solve runs the fused masked-Gram CG, kernel K2
(``cuda_kernels/gram.py``). Everything runs batch-major, (B, N) rows.

Functions that draw noise take the draws as optional tensors (``probes``,
``eps1``/``eps2``, ``init``), so a test can hand this package and the JAX
package the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from ..cuda_kernels import gram
from ..features import ContractedStencil, contract, step_rows
from ..linalg import batched_cg, capturable, cg_solve, rademacher_probes, slq_logdet
from ..utils import profiling
from . import params as P

_LOG2PI = 1.8378770664093453


@dataclasses.dataclass(frozen=True)
class CGSettings:
    """Solver knobs; :meth:`reference_parity` gives the reference's GPyTorch
    configuration."""

    cg_tol: float = 1e-2
    cg_max_iters: int = 100
    num_probes: int = 16
    num_lanczos_iters: int = 15

    @classmethod
    def reference_parity(cls) -> "CGSettings":
        """cg_tolerance=1e-2, num_trace_samples=64,
        max_lanczos_quadrature_iterations=1 (reference
        experiments/sparse/scalable_bo/bo_utils/config.py:6-15)."""
        return cls(cg_tol=1e-2, cg_max_iters=100, num_probes=64, num_lanczos_iters=1)


def _expand_add(v: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter-ADD columns of batch-major v (B, |idx|) into a zero (B, n).
    Adding, not setting: padded observation slots point at node 0 with value
    0 and must not clobber a real observation there."""
    return torch.zeros((v.shape[0], n), dtype=v.dtype, device=v.device).index_add(1, idx, v)


def _expand(v: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of v (|idx|,) or (|idx|, B) set into a zero (n,) or (n, B)."""
    out = torch.zeros((n,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    out[idx] = v
    return out


def _expand_bm(v: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Columns of batch-major v (B, |idx|) set into a zero (B, n)."""
    out = torch.zeros((v.shape[0], n), dtype=v.dtype, device=v.device)
    out[:, idx] = v
    return out


def _masked_gram(k, v: torch.Tensor, noise_var, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``M K M V + σ² M V + (I − M) V`` for batch-major V (B, n) and the 0/1
    mask M, or ``K V + σ² V`` when the mask is None; ``k(V)`` applies K to
    rows, and a 1-D v is one row. The masked operator is block-diagonal: the
    masked-off dims of a padded observation buffer are independent
    unit-variance Gaussians (0 in the quadratic, log 1 = 0 in the logdet)."""
    if v.dim() == 1:
        return _masked_gram(k, v[None, :], noise_var, mask)[0]
    if mask is None:
        return k(v) + noise_var * v
    vm = v * mask[None, :]
    return k(vm) * mask[None, :] + noise_var * vm + (v - vm)


# The uncontracted Gram matvecs: the carry is (params, feats, train_idx) and
# the modulator is formed from the parameters at every product, as the JAX
# package's make_ktt_matvec* do. The solver paths of this module contract the
# features once per solve instead (make_gram_matvec_bm, make_gram_matvec_bm_full).


def make_ktt_matvec(kind: str):
    """Column-major ``(K_tt + σ²I) v`` for v (n_train,) or (n_train, B) over
    any layout with ``matvec`` / ``rmatvec``. carry = (params, feats, train_idx)."""

    def matvec(carry, v):
        params, feats, train_idx = carry
        f = P.modulator(kind, params, feats.max_walk_length)
        u = feats.rmatvec(f, _expand(v, train_idx, feats.num_nodes))
        return feats.matvec(f, u)[train_idx] + P.noise_variance(params) * v

    return matvec


def make_ktt_matvec_bm(kind: str):
    """Batch-major ``(K_tt + σ²I) V`` for V (B, n_train); a 1-D v is one row.
    carry = (params, feats, train_idx)."""

    def matvec(carry, v):
        if v.dim() == 1:
            return matvec(carry, v[None, :])[0]
        params, feats, train_idx = carry
        f = P.modulator(kind, params, feats.max_walk_length)
        u = feats.rmatvec_bm(f, _expand_bm(v, train_idx, feats.num_nodes))
        return feats.matvec_bm(f, u)[:, train_idx] + P.noise_variance(params) * v

    return matvec


def make_ktt_matvec_bm_masked(kind: str):
    """Masked batch-major Gram matvec for padded observation buffers,
    ``M (K_tt + σ²I) M + (I − M)``. carry = (params, feats, train_idx, mask)."""

    def matvec(carry, v):
        params, feats, train_idx, mask = carry
        f = P.modulator(kind, params, feats.max_walk_length)

        def k(rows):
            u = feats.rmatvec_bm(f, _expand_add(rows, train_idx, feats.num_nodes))
            return feats.matvec_bm(f, u)[:, train_idx]

        return _masked_gram(k, v, P.noise_variance(params), mask)

    return matvec


def make_gram_matvec_bm():
    """Batch-major Gram matvec at the train slots over a contracted Φ:
    ``M K_tt M V + σ² M V + (I − M) V`` for the 0/1 slot mask M of a padded
    fixed-capacity observation buffer, or ``K_tt V + σ² V`` when the mask is
    None. carry = (phi, noise_var, train_idx, mask)."""

    def matvec(carry, v):
        profiling.count("gram.full_graph")
        phi, noise_var, train_idx, mask = carry

        def k(rows):
            u = phi.rmatvec_bm(_expand_add(rows, train_idx, phi.num_nodes))
            return phi.matvec_bm(u)[:, train_idx]

        return _masked_gram(k, v, noise_var, mask)

    return matvec


def make_gram_matvec_bm_full():
    """Full-node-space masked operator ``M K M + σ² M + (I − M)`` with M the
    0/1 node mask of train nodes. carry = (phi, noise_var, node_mask)."""

    def matvec(carry, v):
        profiling.count("gram.full_graph")
        phi, noise_var, node_mask = carry
        return _masked_gram(lambda u: phi.matvec_bm(phi.rmatvec_bm(u)), v, noise_var, node_mask)

    return matvec


# The train block's budget in bytes of device memory, for what the build
# allocates once it has counted its pairs of train-row entries that share
# a column (each a product it forms and sums): at most PAIR_BYTES a pair at
# once (int64 indices, keys, sort order and the sort's scratch, float32
# products), and the (L·T)² float32 Gram matrix at most three times (over
# the distinct nodes, then in the two gathers that expand it to the slots).
# At T = 1010 and L 5 the matrices take 0.31 GB; the pairs of 910 train
# nodes are ~0.2 M on the 1000×1000 grid and ~0.6 M on a million-node random
# geometric graph, and would be ~37 M (2.4 GB) were those nodes packed in
# one disc (a build of 35.6 M such pairs peaked at 52 B a pair, in its
# sort, on an H100). Over the budget the fit keeps the full-graph products,
# which need only their vectors.
TRAIN_BLOCK_BUDGET = 1 << 32
PAIR_BYTES = 64


@dataclasses.dataclass(frozen=True)
class TrainBlock:
    """``G[l, a, m, b] = (M_l[t,:] M_m[t,:]ᵀ)[a, b]`` for the train slots t
    of one fit, float32 (L, T, L, T): the Gram matrix of every pair of walk
    steps' train rows, fixed while the modulator moves."""

    gram: torch.Tensor

    def k_tt(self, f: torch.Tensor) -> torch.Tensor:
        """``K_tt = Φ_t Φ_tᵀ = Σ_{l,m} f_l f_m G_lm`` (T, T), differentiable
        in the modulator f."""
        f = f.to(self.gram.dtype)
        return torch.einsum("l,lamb,m->ab", f, self.gram, f)


def build_train_block(feats, train_idx: torch.Tensor) -> Optional[TrainBlock]:
    """The train block of ``train_idx`` (slots may repeat a node), or None
    where none applies: a layout other than stencil or ELL, or a block over
    :data:`TRAIN_BLOCK_BUDGET`.

    A sparse Gram product over the distinct train nodes, so that padded
    slots repeating node 0 add no work. The live entries of the train rows
    (``features.step_rows``) of each node's first slot are sorted by
    column; every pair of entries that share a column gives a product under
    the key (row, row); the products are sorted by key and each key's are
    summed in order by a segment sum. The order of every sum is fixed and
    no atomics are used, so two builds are bit-identical. Each slot then
    reads its node's rows. One read from the device, the counts of live
    entries and of pairs, sizes the pairs before they are made."""
    rows = step_rows(feats, train_idx)
    if rows is None:
        return None
    cols, vals = rows
    l, t, k = vals.shape
    lt = l * t
    dev = vals.device
    with profiling.span("gp.train_block"):
        # each slot's first slot of the same node
        nodes, order = torch.sort(train_idx.to(device=dev, dtype=torch.int64), stable=True)
        first_slot = torch.empty_like(order)
        first_slot[order] = order[torch.searchsorted(nodes, nodes)]
        live = (vals != 0) & (first_slot == torch.arange(t, device=dev)).view(1, t, 1)
        # live entries sorted by column, the others after them, sharing none
        col = torch.where(live, cols.expand(l, t, k), feats.num_target_nodes).reshape(-1)
        col, order = torch.sort(col, stable=True)
        row = torch.arange(lt, device=dev).repeat_interleave(k)[order]
        val = vals.reshape(-1)[order]
        start = torch.searchsorted(col, col)
        share = torch.where(col < feats.num_target_nodes,
                            torch.searchsorted(col, col, right=True) - start, 0)
        with profiling.host_sync():
            entries, pairs = torch.stack([(share > 0).sum(), share.sum()]).tolist()
        profiling.count("train_block.entries", entries)
        profiling.count("train_block.pairs", pairs)
        if 12 * lt * lt + PAIR_BYTES * pairs > TRAIN_BLOCK_BUDGET:
            return None
        # entry i pairs with each entry of its column, from the column's start;
        # the pair-long tensors are dropped as soon as they are used
        i = torch.repeat_interleave(torch.arange(col.numel(), device=dev), share,
                                    output_size=pairs)
        j = torch.arange(pairs, device=dev)
        j += start[i]
        j -= (torch.cumsum(share, 0) - share)[i]
        prod = val[i] * val[j]
        key = row[i] * lt
        key += row[j]
        del i, j
        key, order = torch.sort(key, stable=True)
        prod = prod[order]
        del order
        # each key's products summed in order, as one segment from its first
        # position; the other positions hold empty segments
        pos = torch.arange(pairs, device=dev)
        head = torch.searchsorted(key, key) == pos
        lengths = torch.searchsorted(key, key, right=True)
        lengths -= pos
        del pos
        lengths.masked_fill_(~head, 0)
        sums = torch.segment_reduce(prod, "sum", lengths=lengths)
        del prod, lengths
        gram = torch.zeros(lt * lt + 1, dtype=torch.float32, device=dev)
        gram[torch.where(head, key, lt * lt)] = sums  # the empty ones land in a spare entry
        gram = gram[:-1].view(l, t, l, t)
        return TrainBlock(gram[:, first_slot][:, :, :, first_slot])


@capturable
def _block_gram(carry, v):
    profiling.count("gram.train_block")
    k_tt, noise_var, mask = carry
    return _masked_gram(lambda u: u @ k_tt, v, noise_var, mask)


def make_gram_matvec_block():
    """Batch-major Gram matvec on the train block's dense ``K_tt``:
    ``M K M V + σ² M V + (I − M) V`` for the 0/1 slot mask M, or
    ``K V + σ² V`` when the mask is None. carry = (k_tt, noise_var, mask).

    A slot that repeats a node repeats its row of K, so repeated
    observations add up as the full-graph product's scatter-add does; a
    padded slot's entry of V is masked to 0 before the product, so it adds
    nothing to a real observation of its node. The product is a fixed chain
    of launches with no host read, so on a card ``batched_cg`` runs its
    solves as CUDA graphs (``linalg.capturable``)."""
    return _block_gram


def _compact_gram(feats, f, noise_var, train_idx, mask, block, phi=None):
    """The compact solves' ``(matvec, carry)`` at the train slots: the dense
    ``K_tt`` of ``block`` where there is one, else full-graph products of
    ``phi`` (``contract(feats, f)`` when not given)."""
    if block is not None:
        return make_gram_matvec_block(), (block.k_tt(f), noise_var, mask)
    if phi is None:
        phi = contract(feats, f)
    return make_gram_matvec_bm(), (phi, noise_var, train_idx, mask)


def _fused_gram_solve_bm(phi, noise_var, node_mask, b_solve, settings) -> torch.Tensor:
    """The full-space masked Gram solve through the fused CG
    (``cuda_kernels/gram.gram_cg``, kernel K2 on the card).

    No gradient: prediction solves only; training solves keep ``cg_solve``'s
    adjoint path. Batches above the 16-row launch cap are solved as
    independent chunks (the systems are independent, so no zero rows are
    needed to fill the last chunk).
    """
    outs = [
        gram.gram_cg(
            phi, noise_var, node_mask, b_solve[i : i + gram.MAX_BATCH],
            tol=settings.cg_tol, max_iters=settings.cg_max_iters,
        ).x
        for i in range(0, b_solve.shape[0], gram.MAX_BATCH)
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _node_mask(train_idx, live, n):
    return torch.clamp(
        torch.zeros(n, dtype=torch.float32, device=train_idx.device).index_add(0, train_idx, live),
        max=1.0,
    )


def _distinct(train_idx: torch.Tensor) -> bool:
    return torch.unique(train_idx).numel() == train_idx.numel()


def mll_cg(
    feats,
    params: Dict[str, torch.Tensor],
    train_idx: torch.Tensor,
    y: torch.Tensor,
    *,
    kind: str = "free",
    settings: CGSettings = CGSettings(),
    mask: Optional[torch.Tensor] = None,
    num_real=None,
    full_space: bool = False,
    probes: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    train_block: Optional[TrainBlock] = None,
) -> torch.Tensor:
    """Stochastic estimate of the log marginal likelihood for big N:
    ``−½ (yᵀA⁻¹y + logdet A + n log 2π)``, the quadratic by a differentiable
    CG solve and the logdet by SLQ.

    ``mask``/``num_real`` select the padded fixed-capacity buffers (padded y
    must be 0). ``probes`` are Rademacher rows, (P, n) or (P, N) in full
    space, before masking; by default drawn from ``generator``. The compact
    solves run on ``train_block`` (:func:`build_train_block` of this
    ``train_idx``), built here when none is given, or on full-graph
    products where no block applies.
    """
    n = y.shape[0]
    dev = y.device
    f = P.modulator(kind, params, feats.max_walk_length)
    noise_var = P.noise_variance(params)
    n_term = float(n) if mask is None else torch.as_tensor(num_real, dtype=torch.float32, device=dev)
    if full_space:
        phi = contract(feats, f)
        nn = feats.num_nodes
        live = mask if mask is not None else torch.ones(n, device=dev)
        ym = y if mask is None else y * mask
        node_mask = _node_mask(train_idx, live, nn)
        y_solve = torch.zeros(nn, device=dev).index_add(0, train_idx, ym)
        matvec = make_gram_matvec_bm_full()
        carry = (phi, noise_var, node_mask)
        if probes is None:
            probes = rademacher_probes(nn, settings.num_probes, generator, dev)
        probes = probes * node_mask[None, :]
    else:
        if train_block is None:
            train_block = build_train_block(feats, train_idx)
        matvec, carry = _compact_gram(feats, f, noise_var, train_idx, mask, train_block)
        y_solve = y
        if probes is None:
            probes = rademacher_probes(n, settings.num_probes, generator, dev)
    alpha = cg_solve(matvec, carry, y_solve, settings.cg_tol, settings.cg_max_iters)
    quad = y_solve @ alpha
    logdet = slq_logdet(
        matvec, carry, probes, settings.num_lanczos_iters, settings.cg_tol, settings.cg_max_iters
    )
    return -0.5 * (quad + logdet + n_term * _LOG2PI)


@torch.no_grad()
def pathwise_predict(
    feats,
    params: Dict[str, torch.Tensor],
    train_idx: torch.Tensor,
    y: torch.Tensor,
    test_idx: torch.Tensor,
    *,
    kind: str = "free",
    num_samples: int = 64,
    settings: CGSettings = CGSettings(),
    mask: Optional[torch.Tensor] = None,
    full_space: bool = False,
    eps1: Optional[torch.Tensor] = None,
    eps2: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Matheron-rule posterior samples at test nodes → (num_samples, n_test).

        f_post(x*) = f_prior(x*) + K*,t (K_tt + σ²I)⁻¹ (y − f_prior(t) − ε)

    with prior paths Φ ε₁ and one batched CG solve for all paths.
    ``eps1`` (num_samples, N) and ``eps2`` (num_samples, n_train) are the
    standard-normal draws (ε₂ is scaled by the noise std here); by default
    they come from ``generator``. The prior and the correction
    ``K*,t v = (Φ Φᵀ expand(v))[test]`` are full-graph products; the
    compact residual solve runs on the train block of ``train_idx`` where
    one applies (:func:`build_train_block`), else on full-graph products.

    ``full_space=True``: the residual solve runs in the full node space,
    on a stencil layout through the fused masked-Gram CG (kernel K2): no
    gather or scatter per iteration, the fast path when the train set is a
    sizable fraction of the graph; on the ELL, dense and log layouts, whole
    or split over ranks (``shard.ShardedFeatures``), through ``batched_cg``.
    Requires distinct live train node ids (masked slots may repeat node 0
    with value 0).
    """
    with profiling.span("gp.predict"):
        dev = y.device
        with profiling.span("gp.predict.prior"):
            f = P.modulator(kind, params, feats.max_walk_length)
            phi = contract(feats, f)
            nt = feats.num_target_nodes
            noise_var = P.noise_variance(params)
            if eps1 is None:
                eps1 = torch.randn((num_samples, nt), generator=generator, device=dev)
            if eps2 is None:
                eps2 = torch.randn((num_samples, train_idx.shape[0]), generator=generator,
                                   device=dev)
            prior_all = phi.matvec_bm(eps1)  # (S, N) prior sample paths Φ ε₁
            f_train_prior = prior_all[:, train_idx]
            f_test_prior = prior_all[:, test_idx]
            b = y[None, :] - (f_train_prior + torch.sqrt(noise_var) * eps2)
            if mask is not None:
                # padded residuals are zeroed, so their solution components stay 0
                b = b * mask[None, :]
        with profiling.span("gp.predict.solve"):
            v_full = _predict_solve(feats, phi, f, noise_var, train_idx, b, mask, full_space,
                                    settings)
        with profiling.span("gp.predict.correction"):
            correction = phi.matvec_bm(phi.rmatvec_bm(v_full))[:, test_idx]
            return f_test_prior + correction


def _predict_solve(feats, phi, f, noise_var, train_idx, b, mask, full_space, settings):
    """``pathwise_predict``'s residual solve, scattered to the full node space.

    The compact solve runs on the dense ``K_tt`` of the draw's own train
    block, from the modulator f of ``phi = contract(feats, f)``, where
    :func:`build_train_block` gives one; else, as the full-space solves
    always, on full-graph Φ products."""
    dev = b.device
    n = feats.num_nodes
    if full_space and isinstance(phi, ContractedStencil):
        live = mask if mask is not None else torch.ones(train_idx.shape[0], device=dev)
        return _fused_gram_solve_bm(
            phi, noise_var, _node_mask(train_idx, live, n), _expand_add(b, train_idx, n), settings
        )
    if full_space:
        # the ELL and dense layouts have no fused solve: the same operator
        # through batched_cg, as the JAX package routes them
        live = mask if mask is not None else torch.ones(train_idx.shape[0], device=dev)
        carry = (phi, noise_var, _node_mask(train_idx, live, n))
        return batched_cg(
            make_gram_matvec_bm_full(), carry, _expand_add(b, train_idx, n),
            tol=settings.cg_tol, max_iters=settings.cg_max_iters,
        ).x
    matvec, carry = _compact_gram(feats, f, noise_var, train_idx, mask,
                                  build_train_block(feats, train_idx), phi)
    v = batched_cg(matvec, carry, b, tol=settings.cg_tol, max_iters=settings.cg_max_iters).x
    return _expand_add(v, train_idx, n)


class PosteriorSummary(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor


def summarize_samples(samples: torch.Tensor) -> PosteriorSummary:
    """Mean/variance across the pathwise sample axis."""
    return PosteriorSummary(
        mean=samples.mean(dim=0),
        var=torch.clamp(samples.var(dim=0, unbiased=False), min=1e-12),
    )


@dataclasses.dataclass
class FitResult:
    params: Dict[str, torch.Tensor]
    losses: torch.Tensor


def fit(
    feats,
    train_idx: torch.Tensor,
    y: torch.Tensor,
    *,
    kind: str = "free",
    generator: Optional[torch.Generator] = None,
    init: Optional[Dict[str, torch.Tensor]] = None,
    learning_rate: float = 0.1,
    num_steps: int = 50,
    settings: CGSettings = CGSettings(),
    mask: Optional[torch.Tensor] = None,
    num_real=None,
    full_space: Optional[bool] = None,
    probes: Optional[torch.Tensor] = None,
) -> FitResult:
    """Adam ascent of the CG marginal likelihood, a host loop of
    ``torch.optim.Adam`` steps (reference protocol: Adam lr=0.1).

    ``probes`` (num_steps, P, n) fixes each step's Rademacher draws; by
    default every step draws fresh ones from ``generator``. ``full_space``
    None picks the full-node-space solver when there is no mask, the train
    set is at least an eighth of the graph and its ids are distinct; True
    demands distinct ids. A compact fit builds its train block once
    (:func:`build_train_block`): the train set and mask are fixed for all of
    its steps.
    """
    with profiling.span("gp.fit"):
        dev = y.device
        if init is None:
            init = P.init_params(kind, feats.max_walk_length, generator=generator, device=dev)
        if mask is not None and num_real is None:
            num_real = mask.sum()
        if full_space is None:
            full_space = (
                mask is None and train_idx.shape[0] * 8 >= feats.num_nodes
                and _distinct(train_idx)
            )
        elif full_space and not _distinct(train_idx):
            # the full-space scatter would merge repeated observations of a node
            raise ValueError(
                "full_space=True requires distinct train node ids (use the compact "
                "path for repeated observations)"
            )
        block = None if full_space else build_train_block(feats, train_idx)
        p = {k: v.detach().clone().to(dev).requires_grad_(True) for k, v in init.items()}
        opt = torch.optim.Adam(list(p.values()), lr=learning_rate)
        losses = []
        for i in range(num_steps):
            with profiling.span("gp.step"):
                opt.zero_grad(set_to_none=True)
                with profiling.span("gp.mll"):
                    loss = -mll_cg(
                        feats, p, train_idx, y, kind=kind, settings=settings, mask=mask,
                        num_real=num_real, full_space=full_space,
                        probes=None if probes is None else probes[i], generator=generator,
                        train_block=block,
                    )
                # the adjoint and probe solves; on a card autograd runs
                # them on its own thread, which nests in this span
                with profiling.span("gp.backward", lend=True):
                    loss.backward()
                with profiling.span("gp.adam"):
                    opt.step()
                losses.append(loss.detach())
        return FitResult(
            params={k: v.detach() for k, v in p.items()},
            losses=torch.stack(losses) if losses else torch.zeros(0, device=dev),
        )
