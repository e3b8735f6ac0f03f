"""Carry state across from the JAX package as numpy arrays.

Hyperparameters and step matrices leave the JAX package as numpy arrays
(``np.asarray`` on its arrays, or its npz caches); these functions turn them
into this package's tensors on a chosen device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .features import (
    CSC_FIELDS,
    CscStepMatrices,
    DenseFeatures,
    EllFeatures,
    EllStepMatrices,
    LogFeatures,
    StencilStepMatrices,
)
from .gp.spectral import Eigenbasis
from .walker import WalkLog

PARAM_NAMES = ("raw_noise", "modulator", "raw_beta", "raw_sigma_f")


def params_from_jax(params: Dict[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """A JAX hyperparameter dict (``raw_noise`` with ``modulator``, or with
    ``raw_beta`` / ``raw_sigma_f`` for the diffusion, exact-diffusion and
    spectral models) as float32 tensors."""
    unknown = set(params) - set(PARAM_NAMES)
    if unknown:
        raise ValueError(f"unknown parameter names {sorted(unknown)}; expected {PARAM_NAMES}")
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
            for k, v in params.items()}


def svgp_params_from_jax(params: Dict[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """A JAX SVGP parameter dict: the kernel's parameters (as
    :func:`params_from_jax`) plus ``q_mu`` (M, C) and ``q_sqrt`` (C, M, M),
    as float32 tensors."""
    variational = {k: params[k] for k in ("q_mu", "q_sqrt")}
    m, c = np.shape(variational["q_mu"])
    if np.shape(variational["q_sqrt"]) != (c, m, m):
        raise ValueError(f"q_sqrt {np.shape(variational['q_sqrt'])} does not match q_mu {(m, c)}")
    out = params_from_jax({k: v for k, v in params.items() if k not in variational}, device)
    out.update({k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
                for k, v in variational.items()})
    return out


def gcn_params_from_jax(params: Dict[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """A JAX GCN parameter dict (``w{i}`` (in, out) and ``b{i}`` (out,) for
    each layer) as float32 tensors, the ``state_dict`` of
    ``baselines.gnn.GCN``."""
    layers = len(params) // 2
    names = {f"{p}{i}" for i in range(layers) for p in "wb"}
    if set(params) != names:
        raise ValueError(f"GCN parameters {sorted(params)}; expected {sorted(names)}")
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
            for k, v in params.items()}


def ell_from_numpy(
    cols: np.ndarray, vals: np.ndarray, num_target_nodes: int, device="cpu"
) -> EllStepMatrices:
    """ELL step matrices from (L, N, R) cols / vals arrays."""
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if cols.shape != vals.shape or cols.ndim != 3:
        raise ValueError(f"cols {cols.shape} and vals {vals.shape} must be equal (L, N, R)")
    return EllStepMatrices(
        cols=torch.from_numpy(cols.astype(np.int32)).to(device),
        vals=torch.from_numpy(vals.astype(np.float32)).to(device),
        num_target_nodes=int(num_target_nodes),
    )


def ell_features_from_jax(
    cols: np.ndarray, vals: np.ndarray, num_target_nodes: int, csc=None, device="cpu"
) -> EllFeatures:
    """ELL features from the JAX package's (L, N, R) step matrices and,
    optionally, their column-sorted transpose: an object with the fields
    ``rows``, ``vals``, ``seg_start``, ``last_pos``, ``has_any`` (the JAX
    package's ``CscStepMatrices``) or a mapping of them (its ``.csc.npz``)."""
    mats = ell_from_numpy(cols, vals, num_target_nodes, device)
    if csc is None:
        return EllFeatures(mats)
    get = csc.__getitem__ if hasattr(csc, "keys") else lambda k: getattr(csc, k)
    parts = [np.array(get(k)) for k in CSC_FIELDS]
    steps_cols = (mats.max_walk_length, int(num_target_nodes))
    if parts[0].shape != parts[1].shape or parts[3].shape != steps_cols:
        raise ValueError(
            f"transpose rows {parts[0].shape}, vals {parts[1].shape}, last_pos "
            f"{parts[3].shape} do not match the ELL {tuple(mats.cols.shape)}"
        )
    return EllFeatures(mats, CscStepMatrices(*(torch.from_numpy(p).to(device) for p in parts)))


def log_features_from_jax(
    curs: np.ndarray, loads: np.ndarray, num_target_nodes: int, device="cpu"
) -> LogFeatures:
    """Walk-log features from the JAX package's (L, N, W) ``WalkLog`` arrays
    (``curs`` int, ``loads`` float)."""
    curs = np.asarray(curs)
    loads = np.asarray(loads)
    if curs.shape != loads.shape or curs.ndim != 3:
        raise ValueError(f"curs {curs.shape} and loads {loads.shape} must be equal (L, N, W)")
    return LogFeatures(
        WalkLog(torch.from_numpy(curs.astype(np.int32)).to(device),
                torch.from_numpy(loads.astype(np.float32)).to(device)),
        num_target_nodes=int(num_target_nodes),
    )


def stencil_from_numpy(vals: np.ndarray, offsets: np.ndarray, device="cpu") -> StencilStepMatrices:
    """Stencil step matrices from (L, S, N) vals and the (S,) offset array."""
    vals = np.asarray(vals)
    offsets = np.asarray(offsets)
    if vals.ndim != 3 or offsets.shape != (vals.shape[1],):
        raise ValueError(f"vals {vals.shape} and offsets {offsets.shape} do not match")
    return StencilStepMatrices(
        vals=torch.from_numpy(vals.astype(np.float32)).to(device),
        offsets=offsets.astype(np.int32),
    )


def dense_from_numpy(step_matrices: np.ndarray, device="cpu") -> DenseFeatures:
    """Dense features from an (L, N, Nt) step-matrix array."""
    step_matrices = np.asarray(step_matrices)
    if step_matrices.ndim != 3:
        raise ValueError(f"step_matrices {step_matrices.shape} must be (L, N, Nt)")
    return DenseFeatures(torch.from_numpy(step_matrices.astype(np.float32)).to(device))


def eigenbasis_from_numpy(evals: np.ndarray, evecs: np.ndarray, device="cpu") -> Eigenbasis:
    """An eigenbasis from the JAX package's (N,) eigenvalues and (N, N)
    eigenvector columns. Eigenvectors are free in sign (and in basis within a
    repeated eigenvalue), so two ``eigh`` calls need not agree: carry one
    decomposition across to compute the same thing in both packages."""
    evals = np.asarray(evals)
    evecs = np.asarray(evecs)
    if evals.ndim != 1 or evecs.shape != (evals.shape[0], evals.shape[0]):
        raise ValueError(f"evals {evals.shape} and evecs {evecs.shape} do not match")
    return Eigenbasis(
        evals=torch.from_numpy(evals.astype(np.float32)).to(device),
        evecs=torch.from_numpy(evecs.astype(np.float32)).to(device),
    )
