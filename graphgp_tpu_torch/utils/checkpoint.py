"""Checkpoints of learned parameters: kernel hyperparameters, SVGP
variational state, an optimizer's ``state_dict``.

Counterpart of ``graphgp_tpu/utils/checkpoint.py``. Any nest of dicts, lists
and tensors is written by ``torch.save`` and read back by
``torch.load(weights_only=True)``, which unpickles tensors and containers
only. :func:`load_params` also reads the JAX package's flat-dict ``.npz``
checkpoints, so parameters saved there can be loaded here.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch


def save_params(path: str, params: Any) -> None:
    """Write a nest of dicts, lists and tensors to ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(params, path)


def _like(value: Any, like: Any) -> Any:
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(value).to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        return {k: _like(value[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_like(x, y) for x, y in zip(value, like))
    return value


def load_params(path: str, like: Optional[Any] = None) -> Any:
    """Read what :func:`save_params` wrote, or a JAX flat-dict ``.npz``
    (``path`` with or without its suffix) as a dict of tensors. ``like``,
    a nest of the same structure, gives each tensor its device and dtype."""
    path = os.path.abspath(path)
    if not path.endswith(".npz") and not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"
    if path.endswith(".npz"):
        with np.load(path) as z:
            out = {k: torch.from_numpy(z[k]) for k in z.files}
    else:
        out = torch.load(path, map_location="cpu", weights_only=True)
    return out if like is None else _like(out, like)
