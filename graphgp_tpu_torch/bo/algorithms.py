"""Bayesian-optimization node-selection algorithms.

Counterpart of ``graphgp_tpu/bo/algorithms.py``. The graph-traversal
baselines (Random/BFS/DFS/Greedy) are host-side frontier bookkeeping in
numpy and pick the same nodes as the JAX package for the same rng.
``GRFThompson`` is the compute path: GRF-GP Thompson sampling by pathwise
conditioning on the card.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional

import numpy as np
import torch

from ..devices import resolve_device
from ..utils import profiling


class Algorithm(ABC):
    """select_next_points / update protocol."""

    def __init__(self, n_nodes: int, rng: np.random.Generator):
        self.n_nodes = n_nodes
        self.rng = rng

    @abstractmethod
    def select_next_points(
        self, observed_idx: np.ndarray, observed_y: np.ndarray, batch_size: int = 1
    ) -> List[int]:
        ...

    def update(self, observed_idx: np.ndarray, observed_y: np.ndarray) -> None:
        pass


class RandomSearch(Algorithm):
    def select_next_points(self, observed_idx, observed_y, batch_size=1):
        return self.rng.choice(self.n_nodes, size=batch_size, replace=False).tolist()


class _TraversalBase(Algorithm):
    def __init__(self, adjacency_csr, n_nodes, rng):
        super().__init__(n_nodes, rng)
        self.adj = adjacency_csr.tocsr()
        self.visited: set = set()

    def _neighbors(self, node: int) -> List[int]:
        return self.adj.indices[self.adj.indptr[node] : self.adj.indptr[node + 1]].tolist()

    def _random_unvisited(self, exclude: set) -> Optional[int]:
        """A uniformly random node outside visited ∪ exclude, by rejection
        sampling (visited ≪ N at BO scale), with an exact fallback."""
        for _ in range(64):
            cand = int(self.rng.integers(self.n_nodes))
            if cand not in self.visited and cand not in exclude:
                return cand
        unvisited = list(set(range(self.n_nodes)) - self.visited - exclude)
        if not unvisited:
            return None
        return int(self.rng.choice(unvisited))

    def update(self, observed_idx, observed_y):
        self.visited.update(int(i) for i in observed_idx)


class BFS(_TraversalBase):
    """FIFO frontier expansion."""

    _POP_INDEX = 0  # FIFO; DFS overrides to -1

    def __init__(self, adjacency_csr, n_nodes, rng):
        super().__init__(adjacency_csr, n_nodes, rng)
        self.queue: List[int] = []
        self._queued: set = set()

    def _expand_from(self, node, selected):
        for nb in self._neighbors(node):
            if nb not in self.visited and nb not in self._queued and nb not in selected:
                self.queue.append(nb)
                self._queued.add(nb)

    def _prune(self):
        self.queue = [n for n in self.queue if n not in self.visited]
        self._queued = set(self.queue)

    def select_next_points(self, observed_idx, observed_y, batch_size=1):
        if not self.queue:
            self._expand_from(int(self.rng.choice(observed_idx)), set())
        self._prune()
        selected: List[int] = []
        sel_set: set = set()
        while len(selected) < batch_size:
            if not self.queue:
                self._expand_from(int(self.rng.choice(observed_idx)), sel_set)
            if self.queue:
                node = self.queue.pop(self._POP_INDEX)
                self._queued.discard(node)
            else:
                node = self._random_unvisited(sel_set)
                if node is None:
                    break
            selected.append(node)
            sel_set.add(node)
        return selected

    def update(self, observed_idx, observed_y):
        super().update(observed_idx, observed_y)
        self._prune()


class DFS(BFS):
    """LIFO variant: pop from the end."""

    _POP_INDEX = -1


class GreedySearch(_TraversalBase):
    """Expand neighbourhoods of the best observed nodes."""

    def __init__(self, adjacency_csr, n_nodes, rng):
        super().__init__(adjacency_csr, n_nodes, rng)
        self.frontier: set = set()

    def select_next_points(self, observed_idx, observed_y, batch_size=1):
        observed_idx = np.asarray(observed_idx).astype(int)
        observed_y = np.asarray(observed_y)
        if not self.frontier:
            best = int(observed_idx[np.argmax(observed_y)])
            self.frontier.update(n for n in self._neighbors(best) if n not in self.visited)
        self.frontier -= self.visited
        if len(self.frontier) < batch_size:
            for ix in np.argsort(observed_y)[-3:]:
                node = int(observed_idx[ix])
                self.frontier.update(n for n in self._neighbors(node) if n not in self.visited)
        self.frontier -= self.visited
        if self.frontier:
            selected = sorted(self.frontier)[:batch_size]
            self.frontier -= set(selected)
            return list(selected)
        selected: List[int] = []
        sel_set: set = set()
        for _ in range(batch_size):
            node = self._random_unvisited(sel_set)
            if node is None:
                break
            selected.append(node)
            sel_set.add(node)
        if selected:
            return selected
        take = min(batch_size, self.n_nodes)
        return self.rng.choice(self.n_nodes, size=take, replace=False).tolist()

    def update(self, observed_idx, observed_y):
        super().update(observed_idx, observed_y)
        self.frontier -= self.visited


def _next_capacity(size: int, minimum: int = 64) -> int:
    """Power-of-two observation capacity ≥ size."""
    cap = minimum
    while cap < size:
        cap *= 2
    return cap


class GRFThompson(Algorithm):
    """GRF-GP Thompson sampling via pathwise conditioning.

    Retrains the GP every ``retrain_interval`` new observations (Adam ×
    ``train_epochs``), then draws one posterior sample at every node and picks
    the top-k among unvisited nodes. Observations ride a fixed-capacity padded
    buffer with a 0/1 mask, as in the JAX package.

    All draws (fit init, probes, Thompson ε) come from one ``torch.Generator``
    seeded per BO seed from the host rng, so Thompson draws differ across
    protocol seeds. ``phase_seconds`` records each fit and draw, each ended by
    a device synchronize: the readings of the recorder's ``bo.fit`` and
    ``bo.draw`` spans (``utils.profiling``).
    """

    def __init__(
        self,
        features,
        n_nodes: int,
        rng: np.random.Generator,
        *,
        kind: str = "free",
        learning_rate: float = 0.1,
        train_epochs: int = 50,
        retrain_interval: int = 10,
        settings=None,
        torch_seed: Optional[int] = None,
        observation_capacity: Optional[int] = None,
        device="cuda",
    ):
        super().__init__(n_nodes, rng)
        from ..gp import iterative

        self.device = resolve_device(device)
        self.features = features.to(self.device)
        self.kind = kind
        self.learning_rate = learning_rate
        self.train_epochs = train_epochs
        self.retrain_interval = retrain_interval
        self.settings = settings or iterative.CGSettings()
        self.observation_capacity = observation_capacity
        self.visited: set = set()
        self.cached_params = None
        self.last_training_size = 0
        if torch_seed is None:
            # derived from the per-BO-seed host rng: a fixed seed made every
            # protocol seed's GRF cell identical (regret std 0.0000)
            torch_seed = int(rng.integers(2**31 - 1))
        self.generator = torch.Generator(device=self.device).manual_seed(torch_seed)
        self.phase_seconds: Dict[str, List[float]] = {"fit": [], "draw": []}

    def _should_retrain(self, current_size: int) -> bool:
        return (
            self.cached_params is None
            or self.retrain_interval == 0
            or (current_size - self.last_training_size) >= self.retrain_interval
        )

    def _padded_observations(self, observed_idx, observed_y):
        size = observed_idx.size
        cap = self.observation_capacity
        if cap is None or cap < size:
            cap = _next_capacity(size)
        pad_idx = np.zeros(cap, np.int64)
        pad_idx[:size] = observed_idx
        pad_y = np.zeros(cap, np.float32)
        pad_y[:size] = observed_y
        mask = np.zeros(cap, np.float32)
        mask[:size] = 1.0
        return pad_idx, pad_y, mask

    def _sync(self):
        if self.device.type == "cuda":
            with profiling.host_sync():
                torch.cuda.synchronize(self.device)

    def select_next_points(self, observed_idx, observed_y, batch_size=1):
        from ..gp import iterative

        with profiling.span("bo.select"):
            with profiling.span("bo.upload"):
                observed_idx = np.asarray(observed_idx).astype(np.int64)
                observed_y = np.asarray(observed_y, dtype=np.float32)
                pad_idx, pad_y, mask = self._padded_observations(observed_idx, observed_y)
                dev = self.device
                train_idx = torch.from_numpy(pad_idx).to(dev)
                y = torch.from_numpy(pad_y).to(dev)
                mask_t = torch.from_numpy(mask).to(dev)

            if self._should_retrain(observed_idx.size):
                with profiling.timed("bo.fit") as phase:
                    res = iterative.fit(
                        self.features, train_idx, y, kind=self.kind, generator=self.generator,
                        init=self.cached_params, learning_rate=self.learning_rate,
                        num_steps=self.train_epochs, settings=self.settings, mask=mask_t,
                        num_real=float(observed_idx.size),
                    )
                    self.cached_params = res.params
                    self.last_training_size = observed_idx.size
                    self._sync()
                self.phase_seconds["fit"].append(phase.seconds)

            # Thompson-sample at ALL nodes, then exclude everything ever visited
            # and the currently observed set on the host.
            with profiling.timed("bo.draw") as phase:
                sample = iterative.pathwise_predict(
                    self.features, self.cached_params, train_idx, y,
                    torch.arange(self.n_nodes, device=dev), kind=self.kind, num_samples=1,
                    settings=self.settings, mask=mask_t, generator=self.generator,
                )[0]
                with profiling.host_sync():
                    scores = sample.cpu().numpy().astype(np.float32, copy=True)
            self.phase_seconds["draw"].append(phase.seconds)
            with profiling.span("bo.pick"):
                visited = np.fromiter(self.visited, dtype=np.int64, count=len(self.visited))
                exclude = np.union1d(visited, observed_idx).astype(np.int64)
                scores[exclude] = -np.inf
                n_avail = self.n_nodes - exclude.size
                take = min(batch_size, max(n_avail, 0))
                if take == 0:
                    return []
                top = np.argpartition(-scores, take - 1)[:take]
                return top[np.argsort(-scores[top])].tolist()

    def update(self, observed_idx, observed_y):
        self.visited.update(int(i) for i in observed_idx)
