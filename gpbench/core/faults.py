"""Faults planted in the program, each one a way a later change could break
the timed path, to see the check call the run incorrect: the CPU tests
plant them at a tiny size, ``control.py --fault`` at a cell's own size.

``plant(name)`` patches the program and returns the function that undoes it.
"""
from __future__ import annotations

from typing import Callable, List


def _patcher():
    undo: List[Callable[[], None]] = []

    def patch(owner, attr, value):
        original = getattr(owner, attr)
        setattr(owner, attr, value)
        undo.append(lambda: setattr(owner, attr, original))
        return original

    def restore():
        while undo:
            undo.pop()()

    return patch, restore


def plant(name: str) -> Callable[[], None]:
    import torch

    from graphgp_tpu_torch import features, preprocessor
    from graphgp_tpu_torch.bo import algorithms
    from graphgp_tpu_torch.gp import iterative

    patch, restore = _patcher()
    if name == "state_unchanged":  # a BO step hands back its first picks again
        original = algorithms.GRFThompson.select_next_points

        def stuck(self, observed_idx, observed_y, batch_size=1):
            if not hasattr(self, "_first"):
                self._first = original(self, observed_idx, observed_y, batch_size)
            return list(self._first)
        patch(algorithms.GRFThompson, "select_next_points", stuck)
    elif name == "params_unchanged":  # the fit's Adam steps leave the parameters
        patch(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif name == "dw_zero":  # the modulator's gradient through Φ comes out zero
        from graphgp_tpu_torch.cuda_kernels import stencil

        for owner, attr in ((stencil, "dw_matvec"), (features, "_ell_df")):
            fn = getattr(owner, attr)
            patch(owner, attr, lambda *a, _fn=fn, **k: _fn(*a, **k) * 0)
    elif name == "cg_loose":  # the solves stop at ten times the stated tolerance
        from graphgp_tpu_torch import linalg

        for owner in (linalg, iterative):
            fn = owner.batched_cg
            patch(owner, "batched_cg",
                  lambda m, c, b, _fn=fn, **k: _fn(m, c, b, **dict(k, tol=10 * k["tol"])))
    elif name == "half_batch":  # SLQ over half the probes, the mean over the rest
        original = iterative.slq_logdet

        def half(matvec, carry, probes, *a, **k):
            return original(matvec, carry, probes[: probes.shape[0] // 2], *a, **k)
        patch(iterative, "slq_logdet", half)
    elif name == "fit_half_observations":  # the fit sees the first half of them
        original = iterative.fit

        def half_fit(feats, train_idx, y, **k):
            mask = k["mask"].clone()
            live = int(mask.sum())
            mask[live // 2:] = 0.0
            k.update(mask=mask, num_real=float(mask.sum()))
            return original(feats, train_idx, y * mask, **k)
        patch(iterative, "fit", half_fit)
    elif name == "answer_altered":  # the last pick of a step swapped for another node
        original = algorithms.GRFThompson.select_next_points

        def altered(self, observed_idx, observed_y, batch_size=1):
            picks = original(self, observed_idx, observed_y, batch_size)
            return picks[:-1] + [(picks[-1] + 1) % self.n_nodes]
        patch(algorithms.GRFThompson, "select_next_points", altered)
    elif name == "build_unchanged":  # every build returns the first build's features
        original = preprocessor.preprocess_graph
        kept = {}

        def same(*a, **k):
            if "f" not in kept:
                kept["f"] = original(*a, **k)
            return kept["f"]
        patch(preprocessor, "preprocess_graph", same)
    elif name == "half_walks":  # half of each node's walks, the mean over the rest
        original = features.consolidate

        def half_walks(log, capacity, num_target_nodes=None, walks_per_node=None):
            w = log.walks_per_node // 2
            part = type(log)(log.curs[..., :w], log.loads[..., :w])
            return original(part, capacity, num_target_nodes, walks_per_node=w)
        patch(preprocessor, "consolidate", half_walks)
    elif name == "value_altered":  # each build's step-matrix values off by 1e-3
        original = preprocessor._apply_layout

        def scaled(mats, *a, **k):
            mats = type(mats)(mats.cols, mats.vals * 1.001, mats.num_target_nodes)
            return original(mats, *a, **k)
        patch(preprocessor, "_apply_layout", scaled)
    else:
        raise KeyError(f"no fault {name!r}")
    return restore
