"""Hyperparameter dictionaries and transforms for GRF graph-GP models.

Counterpart of ``graphgp_tpu/gp/params.py``:

* ``kind='free'``: the modulator vector f itself is learned;
* ``kind='diffusion'``: f = σ_f · Taylor(exp(−βL/2)), β and σ_f softplus-positive;
* ``kind='exact_diffusion'``: the same two parameters, handed on as the pair
  (β, σ_f) to a spectral layout (``gp.spectral.SpectralDiffusionFeatures``),
  which applies exp(−βλ/2) to the eigenvalues: no Taylor truncation.

Noise is softplus-positive, floored for numerical safety.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..modulators import diffusion_modulator, free_modulator_init, inv_softplus, softplus

NOISE_FLOOR = 1e-6
_KINDS = "(want 'free'|'diffusion'|'exact_diffusion')"


def init_params(
    kind: str,
    max_walk_length: int,
    *,
    generator: Optional[torch.Generator] = None,
    noise: float = 0.1,
    beta: float = 1.0,
    sigma_f: float = 1.0,
    modulator_init: Optional[torch.Tensor] = None,
    device="cpu",
) -> Dict[str, torch.Tensor]:
    """Initial parameters. ``noise`` is the initial noise *std*; the free
    modulator is a standard-normal draw from ``generator`` unless
    ``modulator_init`` gives it explicitly."""
    params = {"raw_noise": inv_softplus(torch.tensor(noise, dtype=torch.float32) ** 2)}
    if kind == "free":
        if modulator_init is None:
            modulator_init = free_modulator_init(max_walk_length, generator, device)
        params["modulator"] = torch.as_tensor(modulator_init, dtype=torch.float32)
    elif kind in ("diffusion", "exact_diffusion"):
        params["raw_beta"] = inv_softplus(beta)
        params["raw_sigma_f"] = inv_softplus(sigma_f)
    else:
        raise ValueError(f"unknown kernel kind {kind!r} {_KINDS}")
    return {k: v.to(device) for k, v in params.items()}


def modulator(kind: str, params: Dict[str, torch.Tensor], max_walk_length: int) -> torch.Tensor:
    if kind == "free":
        return params["modulator"]
    if kind not in ("diffusion", "exact_diffusion"):
        raise ValueError(f"unknown kernel kind {kind!r} {_KINDS}")
    beta = softplus(params["raw_beta"])
    sigma_f = softplus(params["raw_sigma_f"])
    if kind == "exact_diffusion":
        return torch.stack([beta, sigma_f])
    return sigma_f * diffusion_modulator(max_walk_length, beta)


def noise_variance(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    return softplus(params["raw_noise"]) + NOISE_FLOOR


def describe(kind: str, params: Dict[str, torch.Tensor], max_walk_length: int) -> dict:
    """Host-side readable summary (for result CSVs and logging)."""
    out = {"noise_variance": float(noise_variance(params))}
    if kind == "free":
        out["modulator_norm"] = float(torch.linalg.norm(params["modulator"]))
    else:
        out["beta"] = float(softplus(params["raw_beta"]))
        out["sigma_f"] = float(softplus(params["raw_sigma_f"]))
    return out
