"""The calls into the system under test, ``graphgp_tpu_torch``: the inputs
it is handed, its feature build, and the probes around its layers.

This is the only module of the harness that imports the program; the
reference imports none of it.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import peaks
from .probes import detach


def load_graph(cell) -> dict:
    """The configuration's graph and objective, made or read from the seed:
    ``{"adjacency", "objective"}`` (float32 targets, gaussianized where the
    configuration says so)."""
    from graphgp_tpu_torch.cli import bo as cli_bo
    from graphgp_tpu_torch.data import synthetic
    from graphgp_tpu_torch.data.database import GraphDataLoader

    g = cell.config["graph"]
    if "generator" in g:
        data = synthetic.generate(g["generator"], g["n_nodes"], seed=cell.config["seeds"]["data"])
    else:
        where = os.path.join(cell.root, g["directory"])
        data = GraphDataLoader(data_root=where, cache_dir=where)(g["dataset"])
    objective = np.asarray(data["y_observed"], dtype=np.float32)
    if cell.config.get("bo", {}).get("gaussianize"):
        objective = cli_bo.gaussianize(objective)
    return {"adjacency": data["adjacency"], "objective": objective}


def walk_config(cell):
    from graphgp_tpu_torch.walker import WalkConfig

    w = cell.config["walks"]
    return WalkConfig(walks_per_node=w["walks_per_node"], p_halt=w["p_halt"],
                      max_walk_length=w["max_walk_length"])


def build_features(cell, adjacency, walk_seed: int, trace: dict):
    """One GRF feature build, as the BO CLI makes it: no cache on disk, the
    layout chosen by the graph."""
    from graphgp_tpu_torch.preprocessor import preprocess_graph

    with cell.probes.span("walk_consolidate"):
        feats = preprocess_graph(adjacency, walk_config(cell), seed=walk_seed, cache_dir=None,
                                 layout="auto", device=cell.device, trace=trace)
        cell.sync()
    return feats


def install_layout_span(cell) -> None:
    from graphgp_tpu_torch import preprocessor

    cell.probes.spanned(preprocessor, "_apply_layout", "layout")


def layout_record(feats, ell, rows: np.ndarray, cols: np.ndarray) -> dict:
    """The program's step matrices at the sampled rows (its ELL, where it is
    given, and its stencil) and its transpose at the sampled columns."""
    from graphgp_tpu_torch.features import EllFeatures, StencilFeatures

    out = {}
    r = torch.as_tensor(rows, dtype=torch.int64)
    if isinstance(feats, StencilFeatures):
        vals = feats.mats.vals
        out["stencil_rows"] = {"offsets": np.asarray(feats.mats.offsets, dtype=np.int64),
                               "vals": vals[:, :, r.to(vals.device)].cpu().numpy()}
    if isinstance(feats, EllFeatures):
        ell = feats.mats
        if feats.csc is not None:
            out["csc_cols"] = csc_columns(feats.csc, cols)
    if ell is not None:
        rr = r.to(ell.cols.device)
        out["ell_rows"] = {"cols": ell.cols[:, rr, :].cpu().numpy(),
                           "vals": ell.vals[:, rr, :].cpu().numpy()}
    return out


def csc_columns(csc, cols) -> list:
    """[[(rows, values) per step] per column] read from the transpose's
    virtual rows, padding left out."""
    ptr = csc.vrow_ptr.cpu()
    blk = csc.rows.shape[-1]
    out = []
    for c in cols:
        per_step = []
        for step in range(csc.max_walk_length):
            a, b = int(ptr[step, c]), int(ptr[step, c + 1])
            rw = csc.rows[step].reshape(-1, blk)[a:b].reshape(-1).cpu().numpy()
            vl = csc.vals[step].reshape(-1, blk)[a:b].reshape(-1).cpu().numpy()
            keep = vl != 0
            per_step.append((rw[keep].astype(np.int64), vl[keep]))
        out.append(per_step)
    return out


def live_entries(feats) -> int:
    """Stored entries of Φ that are not padding (one read from the device)."""
    return int((feats.mats.vals != 0).sum())


def install_operator_counters(cell, feats) -> None:
    """Bytes and operations each product needs, counted at the operator's
    call sites, each call inside a span (``k1`` for the stencil products and
    weight gradients, ``ell`` for the ELL forward and transposed products)
    whose launches the trace attributes to it."""
    from graphgp_tpu_torch import features
    from graphgp_tpu_torch.cuda_kernels import stencil

    c = cell.probes.counters

    def add(kind, work):
        c[f"bytes.{kind}"] += work[0]
        c[f"flops.{kind}"] += work[1]
        c[f"calls.{kind}"] += 1

    def product(w, v, offsets):
        add("k1", peaks.stencil_work(w.shape[0], v.shape[0], w.shape[1]))

    def gradient(v, g, offsets):
        add("k1", peaks.stencil_work(len(offsets), v.shape[0], v.shape[-1]))

    cell.probes.spanned(stencil, "_product", "k1", product)
    cell.probes.spanned(stencil, "dw_matvec", "k1", gradient)
    if isinstance(feats, features.EllFeatures):
        live = live_entries(feats)
        n, nt = feats.num_nodes, feats.num_target_nodes

        def ell(_, __, v):
            add("ell", peaks.sparse_work(live, v.shape[0], n, nt))

        cell.probes.spanned(features, "ell_phi_matvec_bm", "ell", ell)
        cell.probes.spanned(features, "csc_phi_rmatvec_bm", "ell", ell)


def install_gp_probes(cell) -> None:
    """Spans around the fit and the Thompson draw, a count of CG iterations,
    and the captures the check reads.

    Of each fit, the first objective (parameters, probes, the quadratic's
    solve with its iterations and recurrence residual, the value), the
    gradient of that objective as the optimizer gets it, and the parameters
    after the first Adam step, kept as ``fit`` for a fit from drawn
    parameters and ``refit`` for one that starts where the last ended, each
    with the observed set of the ``select`` it ran in. Of each draw, its
    inputs, its solve and its last Φ products."""
    from graphgp_tpu_torch import features, linalg
    from graphgp_tpu_torch.gp import iterative

    p = cell.probes
    flags, caps, counters = p.flags, p.captures, p.counters

    def fit(fn):
        def wrapper(*args, **kwargs):
            flags["fit_kind"] = "fit" if kwargs.get("init") is None else "refit"
            flags["mll_calls"] = 0
            try:
                with p.span("fit"):
                    return fn(*args, **kwargs)
            finally:
                flags["fit_kind"] = None
        return wrapper

    def grad_hook(cap, name):
        def hook(g):
            cap["grad"].setdefault(name, g.detach().clone())
        return hook

    def mll(fn):
        def wrapper(feats, params, train_idx, y, **kwargs):
            kind = flags["fit_kind"]
            flags["mll_calls"] += 1
            if not kind or flags["mll_calls"] > 2:
                return fn(feats, params, train_idx, y, **kwargs)
            if flags["mll_calls"] == 2:  # Adam's first step has been taken
                caps[kind]["params_after"] = detach(params)
                for handle in caps[kind].pop("hooks", []):
                    handle.remove()
                return fn(feats, params, train_idx, y, **kwargs)
            cap = {"params": detach(params), "train_idx": train_idx, "y": y,
                   "mask": kwargs.get("mask"), "num_real": kwargs.get("num_real"),
                   "lanczos_iters": kwargs["settings"].num_lanczos_iters,
                   "observed": caps.get("observed_now"), "grad": {}}
            flags["in_first_mll"] = True
            try:
                out = fn(feats, params, train_idx, y, **kwargs)
            finally:
                flags["in_first_mll"] = False
            cap.update(caps.pop("first_mll", {}), mll=out.detach())
            for name, v in params.items():
                if v.requires_grad:
                    handle = v.register_hook(grad_hook(cap, name))
                    cap.setdefault("hooks", []).append(handle)
            caps[kind] = cap
            return out
        return wrapper

    def probes_of(fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if flags["in_first_mll"]:
                caps.setdefault("first_mll", {})["probes"] = out
            return out
        return wrapper

    def cg_solve(fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if flags["in_first_mll"]:
                caps.setdefault("first_mll", {})["alpha"] = out.detach()
            return out
        return wrapper

    def counted_cg(fn):
        # every CG solve of the window: the forward and adjoint solves of
        # the fits (through linalg) and the draws' (through gp/iterative)
        def wrapper(matvec, carry, b, **kwargs):
            out = fn(matvec, carry, b, **kwargs)
            counters["cg.iterations"] += out.iterations
            counters["cg.solves"] += 1
            if flags["in_first_mll"] and "solve" not in caps.get("first_mll", {}):
                caps.setdefault("first_mll", {})["solve"] = {
                    "iterations": out.iterations, "residual": out.residual_norm.detach()}
            if flags["in_draw"]:
                caps["draw_solve"] = {"b": b, "x": out.x, "iterations": out.iterations,
                                      "residual": out.residual_norm.detach()}
            return out
        return wrapper

    def draw(fn):
        def wrapper(feats, params, train_idx, y, test_idx, **kwargs):
            gen = kwargs.get("generator")
            if kwargs.get("eps1") is None and kwargs.get("eps2") is None:
                s = kwargs.get("num_samples", 64)
                kwargs["eps1"] = torch.randn((s, feats.num_target_nodes), generator=gen,
                                             device=y.device)
                kwargs["eps2"] = torch.randn((s, train_idx.shape[0]), generator=gen,
                                             device=y.device)
            flags["in_draw"] = True
            try:
                with p.span("draw"):
                    out = fn(feats, params, train_idx, y, test_idx, **kwargs)
            finally:
                flags["in_draw"] = False
            caps["draw"] = {"params": detach(params), "train_idx": train_idx, "y": y,
                            "mask": kwargs.get("mask"), "eps1": kwargs["eps1"],
                            "eps2": kwargs["eps2"], "sample": out, "test_idx": test_idx,
                            "solve": caps.pop("draw_solve", None),
                            "products": caps.pop("draw_products", {}),
                            "observed": caps.get("observed_now")}
            return out
        return wrapper

    def product(kind):
        def make(fn):
            def wrapper(self, v):
                out = fn(self, v)
                if flags["in_draw"]:
                    caps.setdefault("draw_products", {})[kind] = (v, out)
                return out
            return wrapper
        return make

    p.patch(iterative, "fit", fit)
    p.patch(iterative, "mll_cg", mll)
    p.patch(iterative, "rademacher_probes", probes_of)
    p.patch(iterative, "cg_solve", cg_solve)
    p.patch(iterative, "pathwise_predict", draw)
    p.patch(iterative, "batched_cg", counted_cg)
    p.patch(linalg, "batched_cg", counted_cg)
    for cls in (features.ContractedStencil, features.ContractedFeatures):
        p.patch(cls, "matvec_bm", product("forward"))
        p.patch(cls, "rmatvec_bm", product("transposed"))


def check_settings(cell, algo, feats) -> None:
    """The configuration's solver settings and precision are the ones the
    algorithm runs with: a key the CLI does not pass on would otherwise be
    a setting that nothing reads."""
    b = cell.config["bo"]
    s = algo.settings
    ran = {"cg_tol": s.cg_tol, "cg_max_iters": s.cg_max_iters, "num_probes": s.num_probes,
           "num_lanczos_iters": s.num_lanczos_iters}
    stated = {k: b[k] for k in ran}
    if ran != stated:
        raise ValueError(f"the configuration states {stated}; the algorithm runs {ran}")
    dtype = str(feats.mats.vals.dtype).replace("torch.", "")
    if dtype != cell.config["precision"]:
        raise ValueError(f"the configuration states {cell.config['precision']}; the "
                         f"features are {dtype}")


def make_thompson(cell, adjacency, feats, bo_seed: int, train_epochs=None):
    """A ``GRFThompson`` made by the BO CLI's ``make_algorithm`` from the
    CLI's own parser, fed the configuration's flags (``train_epochs`` in
    place of the configuration's, for the warm-up)."""
    from graphgp_tpu_torch.cli import bo as cli_bo

    b = cell.config["bo"]
    w = cell.config["walks"]
    argv = ["--initial-points", str(b["initial_points"]), "--iterations", str(b["iterations"]),
            "--batch-size", str(cell.traffic["batch_size"]),
            "--walks-per-node", str(w["walks_per_node"]), "--p-halt", str(w["p_halt"]),
            "--max-walk-length", str(w["max_walk_length"]), "--kernel-kind", b["kernel_kind"],
            "--learning-rate", str(b["learning_rate"]),
            "--train-epochs", str(train_epochs or b["train_epochs"]),
            "--gp-retrain-interval", str(b["gp_retrain_interval"]), "--cg-tol", str(b["cg_tol"]),
            "--device", str(cell.device)]
    args = cli_bo.build_parser().parse_args(argv)
    data = {"y_observed": np.zeros(feats.num_nodes, np.float32), "adjacency": adjacency}
    algo = cli_bo.make_algorithm("grf_thompson", data, feats, args,
                                 np.random.default_rng(bo_seed))
    check_settings(cell, algo, feats)
    return algo


def run_bo(cell, algo, objective, bo_seed: int, iterations: int):
    from graphgp_tpu_torch.bo import run_optimization

    b = cell.config["bo"]
    return run_optimization(algo, objective, n_iterations=iterations,
                            initial_points=b["initial_points"],
                            batch_size=cell.traffic["batch_size"], seed=bo_seed)
