"""Modulator functions f_l weighting the step matrices.

Counterpart of ``graphgp_tpu/modulators.py``. The diffusion modulator is the
Taylor series of ``exp(-βL/2)``: ``f_l = (-β)^l / (2^l · l!)``, so that
``ΦΦᵀ ≈ exp(-βL)``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``logaddexp(x, 0)``, the form the JAX package uses."""
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y) -> torch.Tensor:
    """Inverse of softplus for parameter initialization (y > 0)."""
    y = torch.as_tensor(y, dtype=torch.float32)
    return y + torch.log(-torch.expm1(-y))


def diffusion_modulator(max_walk_length: int, beta: torch.Tensor) -> torch.Tensor:
    """``f_l = (-β)^l / (2^l l!)`` for l = 0..max_walk_length-1, in log space
    with an explicit sign so gradients flow through β without overflow."""
    beta = torch.as_tensor(beta, dtype=torch.float32)
    l = torch.arange(max_walk_length, dtype=torch.float32, device=beta.device)
    log_mag = (
        l * torch.log(torch.clamp(beta.abs(), min=1e-30))
        - l * math.log(2.0)
        - torch.lgamma(l + 1.0)
    )
    sign = torch.where(beta >= 0, (-1.0) ** l, torch.ones_like(l))
    return sign * torch.exp(log_mag)



def geometric_modulator(max_walk_length: int, rho) -> torch.Tensor:
    """``f_l = rho^l``, the geometric-series family."""
    rho = torch.as_tensor(rho, dtype=torch.float32)
    return rho ** torch.arange(max_walk_length, dtype=torch.float32, device=rho.device)

def free_modulator_init(
    max_walk_length: int,
    generator: Optional[torch.Generator] = None,
    device="cpu",
) -> torch.Tensor:
    """Standard-normal init for a learnable modulator vector."""
    return torch.randn(
        max_walk_length, generator=generator, dtype=torch.float32, device=device
    )
