"""Graph-convolutional network regression baseline.

Counterpart of ``graphgp_tpu/baselines/gnn.py`` (the reference's Keras
graph-conv baseline): a small GCN, Kipf–Welling propagation ``Â H W + b``
with ``Â = D̂^{-1/2}(A + I)D̂^{-1/2}``, trained with Adam on the masked MSE of
the observed nodes. The products are dense ``torch.matmul``; the JAX package
computes them outside any Pallas kernel too.

Draws come from a ``torch.Generator``; ``init`` and ``node_features`` take
explicit values, so a test can start both packages from the same numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn


def gcn_propagation_matrix(adj, device="cpu") -> torch.Tensor:
    """Â = D̂^{-1/2} (A + I) D̂^{-1/2} (dense, float32), built in float64."""
    a = adj.toarray() if sp.issparse(adj) else np.asarray(adj)
    a = a + np.eye(a.shape[0])
    dinv = 1.0 / np.sqrt(a.sum(1))
    return torch.from_numpy((a * dinv[:, None] * dinv[None, :]).astype(np.float32)).to(device)


def gcn_forward(params: Dict[str, torch.Tensor], a_hat: torch.Tensor, x: torch.Tensor):
    """(N,) outputs of the layers ``w{i}`` / ``b{i}``, ReLU between them."""
    h = x
    n_layers = len(params) // 2
    for i in range(n_layers):
        h = a_hat @ h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h[:, 0]


class GCN(nn.Module):
    """The layers of ``init_gcn``: He-normal weights ``w{i}`` from
    ``generator``, zero biases ``b{i}``; in_dim → hidden… → 1."""

    def __init__(
        self,
        in_dim: int,
        hidden: Sequence[int] = (64, 64),
        generator: Optional[torch.Generator] = None,
        device="cpu",
    ):
        super().__init__()
        dims = [in_dim, *hidden, 1]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            w = torch.randn((a, b), generator=generator, device=device) * math.sqrt(2.0 / a)
            self.register_parameter(f"w{i}", nn.Parameter(w))
            self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(b, device=device)))

    def forward(self, a_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return gcn_forward(dict(self.named_parameters()), a_hat, x)


@dataclasses.dataclass
class GCNResult:
    params: Dict[str, torch.Tensor]
    losses: torch.Tensor
    predictions: torch.Tensor  # (N,) full-graph predictions


def fit_gcn(
    adj,
    train_idx: torch.Tensor,
    y_train: torch.Tensor,
    *,
    node_features: Optional[torch.Tensor] = None,
    hidden: Sequence[int] = (64, 64),
    learning_rate: float = 1e-2,
    num_steps: int = 500,
    generator: Optional[torch.Generator] = None,
    init: Optional[Dict[str, torch.Tensor]] = None,
) -> GCNResult:
    """Train a GCN regressor on ``y_train``'s device. Without node features it
    uses random positional features (0.1 · standard normal, 32 wide, from
    ``generator``), which the convolutions smooth into structure-aware
    representations; ``init`` gives the layers' starting values."""
    dev = y_train.device
    a_hat = gcn_propagation_matrix(adj, dev)
    n = a_hat.shape[0]
    x = (
        node_features.to(dev)
        if node_features is not None
        else torch.randn((n, 32), generator=generator, device=dev) * 0.1
    )
    model = GCN(x.shape[1], hidden, generator=generator, device=dev)
    if init is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init.items()})
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate)
    losses = []
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(a_hat, x)[train_idx] - y_train) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        predictions = model(a_hat, x)
    return GCNResult(
        params={k: v.detach() for k, v in model.named_parameters()},
        losses=torch.stack(losses) if losses else torch.zeros(0, device=dev),
        predictions=predictions,
    )
