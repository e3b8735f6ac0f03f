"""K1 (the stencil product) and K3 (ELL → stencil): the plain versions
against the JAX package's Pallas kernels in interpret mode, and the
gradients. The CUDA kernels themselves are tested on the card by
test_torch_cuda_kernels.py.

Tolerances: the K1 products sum S float32 terms in another order than the
Pallas window (atol 1e-4, as the JAX package's own kernel tests use); K3
places at most one entry per output cell, so it is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphgp_tpu.pallas_kernels import stencil as ps
from graphgp_tpu.pallas_kernels.stencil_build import ell_to_stencil_pallas
from graphgp_tpu_torch.cuda_kernels import stencil as k1
from graphgp_tpu_torch.cuda_kernels import stencil_build as k3
from graphgp_tpu_torch.features import StencilFeatures, StencilStepMatrices, contract

ATOL = 1e-4


def _random_stencil(n, s, seed, big_offsets=False):
    rng = np.random.default_rng(seed)
    if big_offsets:  # wraparound-style offsets (ring N−1 ≡ −1) and far ones
        offs = np.unique(np.concatenate([[0, 1, n - 1], rng.integers(0, n, s)]))[:s]
    else:
        offs = np.unique(rng.integers(-5, 6, s))
    w = rng.normal(size=(offs.size, n)).astype(np.float32)
    return w, offs.astype(np.int64)


@pytest.mark.parametrize("big_offsets", [False, True])
@pytest.mark.parametrize("b", [1, 4, ps._MAX_BATCH + 3])
def test_plain_matvec_and_rmatvec_match_pallas(big_offsets, b):
    n = 515  # not a lane multiple: exercises the Pallas zero tail
    w, offs = _random_stencil(n, 9, seed=b, big_offsets=big_offsets)
    v = np.random.default_rng(100 + b).normal(size=(b, n)).astype(np.float32)
    w_shift_j = ps.shifted_weights(jnp.asarray(w), ps.center_offsets(offs, n))
    ref_m = ps.matvec_bm(jnp.asarray(w), jnp.asarray(v), offs, interpret=True)
    ref_r = ps.rmatvec_bm(w_shift_j, jnp.asarray(v), offs, interpret=True)
    wt, vt = torch.from_numpy(w), torch.from_numpy(v)
    w_shift_t = k1.shifted_weights(wt, k1.center_offsets(offs, n))
    np.testing.assert_array_equal(w_shift_t.numpy(), np.asarray(w_shift_j))
    np.testing.assert_allclose(
        k1.matvec_bm(wt, vt, offs, w_shift_t).numpy(), np.asarray(ref_m), atol=ATOL
    )
    np.testing.assert_allclose(
        k1.rmatvec_bm(w_shift_t, vt, offs, wt).numpy(), np.asarray(ref_r), atol=ATOL
    )


def test_center_offsets_match():
    offs = np.asarray([0, 1, 5, 639, 320, 321, -3])
    np.testing.assert_array_equal(k1.center_offsets(offs, 640), ps.center_offsets(offs, 640))


@pytest.mark.parametrize("big_offsets", [False, True])
def test_autograd_matches_jax_vjp(big_offsets):
    """dw and dv of the port's autograd Function equal jax.vjp of the Pallas
    kernel's custom VJP (interpret mode)."""
    n, b = 384, 3
    w, offs = _random_stencil(n, 6, seed=7, big_offsets=big_offsets)
    offs_c = tuple(ps.center_offsets(offs, n).tolist())
    c = ps._planned_c(n, w.shape[0], b, offs_c, False)
    rng = np.random.default_rng(8)
    v = rng.normal(size=(b, n)).astype(np.float32)
    g = rng.normal(size=(b, n)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda ww, vv: ps.stencil_matvec_pallas(ww, vv, offs_c, c, True),
        jnp.asarray(w), jnp.asarray(v),
    )
    dw_j, dv_j = vjp(jnp.asarray(g))
    wt = torch.from_numpy(w).requires_grad_(True)
    vt = torch.from_numpy(v).requires_grad_(True)
    partner = k1.shifted_weights(wt.detach(), offs_c)
    (k1.stencil_matvec(wt, vt, offs_c, partner) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), atol=ATOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(dv_j), atol=ATOL)


def test_contract_passes_nonzero_gradient_to_modulator():
    """The modulator's gradient flows through w and w_shift into f (a stencil
    fit once trained nothing because this gradient was stopped), and equals
    the gradient of the plain roll chain with no shifted table."""
    rng = np.random.default_rng(0)
    n, l = 200, 3
    offs = np.asarray([-20, -1, 0, 1, 20, n - 1])
    vals = torch.from_numpy(rng.normal(size=(l, offs.size, n)).astype(np.float32))
    feats = StencilFeatures(StencilStepMatrices(vals=vals, offsets=offs))
    v = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))

    f = torch.tensor([0.7, -0.3, 0.2], requires_grad=True)
    phi = contract(feats, f)
    (phi.matvec_bm(phi.rmatvec_bm(v)) * g).sum().backward()
    grad_kernel_path = f.grad.clone()

    f2 = torch.tensor([0.7, -0.3, 0.2], requires_grad=True)
    w = torch.einsum("l,lsn->sn", f2, vals)
    u = torch.zeros_like(v)
    for s, off in enumerate(offs.tolist()):  # Φᵀ: Σ_s roll(w_s ⊙ v, +off_s)
        u = u + torch.roll(w[s][None, :] * v, off, dims=-1)
    (k1.matvec_plain(w, u, offs.tolist()) * g).sum().backward()

    assert torch.all(grad_kernel_path != 0)
    torch.testing.assert_close(grad_kernel_path, f2.grad, rtol=1e-5, atol=1e-4)


def test_plain_build_matches_pallas_on_random_ell():
    """K3's plain version on a random ELL with distinct live columns per row
    (as consolidation produces), padding slots and off-vocabulary entries."""
    rng = np.random.default_rng(3)
    l, n, r = 2, 300, 7
    vocab = np.asarray([-17, -1, 0, 1, 17, n - 1])
    diffs = np.stack([rng.permutation(np.r_[vocab, 5, 9])[:r] for _ in range(l * n)])
    cols = (np.arange(n)[None, :, None] + diffs.reshape(l, n, r)).astype(np.int32)
    vals = rng.normal(size=(l, n, r)).astype(np.float32)
    vals[rng.random((l, n, r)) < 0.2] = 0.0
    cols[vals == 0.0] = 0
    ref = ell_to_stencil_pallas(jnp.asarray(cols), jnp.asarray(vals),
                                tuple(int(o) for o in vocab), interpret=True)
    out = k3.ell_to_stencil(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(vocab))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cpu_tensors_never_launch():
    k1.launches = k3.launches = 0
    w, offs = _random_stencil(64, 3, seed=1)
    wt = torch.from_numpy(w)
    k1.matvec_bm(wt, torch.ones(2, 64), offs, k1.shifted_weights(wt, k1.center_offsets(offs, 64)))
    k3.ell_to_stencil(torch.zeros(1, 64, 2, dtype=torch.int32), torch.zeros(1, 64, 2),
                      torch.tensor([0, 1]))
    assert k1.launches == 0 and k3.launches == 0
