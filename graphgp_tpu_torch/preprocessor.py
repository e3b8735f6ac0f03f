"""Graph preprocessing: Laplacian → walks → step matrices, with a disk cache.

Counterpart of ``graphgp_tpu/preprocessor.py``, with the same md5 cache key
and the same npz layout (``step_matrices_<key>.npz`` holding cols / vals /
num_target_nodes; the ``.stencil.npz`` sidecar holding vals / offsets of a
structured graph; the ``.csc.npz`` sidecar holding the column-sorted
transpose of an unstructured one: rows, vals, seg_start, last_pos, has_any),
so either package reads the other's cache.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from .devices import resolve_device
from .features import (
    CSC_FIELDS,
    CscStepMatrices,
    EllFeatures,
    EllStepMatrices,
    StencilFeatures,
    StencilStepMatrices,
    consolidate,
    ell_to_stencil,
    suggest_row_capacity,
    with_transpose,
)
from .graphs import pack_laplacian
from .pipeline import DEFAULT_LOG_BUDGET_BYTES, blocked_ell_features
from .utils import profiling
from .walker import WalkConfig, sample_walk_log

def _cache_key(adjacency, cfg: WalkConfig, seed: int) -> str:
    import scipy.sparse as sp

    h = hashlib.md5()
    if sp.issparse(adjacency):
        csr = adjacency.tocsr()
        h.update(csr.indptr.tobytes())
        h.update(csr.indices.tobytes())
        h.update(np.asarray(csr.data, dtype=np.float64).tobytes())
    else:
        h.update(np.ascontiguousarray(adjacency, dtype=np.float64).tobytes())
    h.update(
        f"w{cfg.walks_per_node}_p{cfg.p_halt}_l{cfg.max_walk_length}"
        f"_a{cfg.ablation}_s{seed}".encode()
    )
    return h.hexdigest()


def save_step_matrices(path: str, mats: EllStepMatrices) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        cols=mats.cols.cpu().numpy(),
        vals=mats.vals.cpu().numpy(),
        num_target_nodes=mats.num_target_nodes,
    )


def load_step_matrices(path: str, device="cpu") -> EllStepMatrices:
    with np.load(path) as z:
        return EllStepMatrices(
            cols=torch.from_numpy(z["cols"]).to(device),
            vals=torch.from_numpy(z["vals"]).to(device),
            num_target_nodes=int(z["num_target_nodes"]),
        )


def preprocess_graph(
    adjacency,
    cfg: WalkConfig,
    *,
    seed: int = 42,
    cache_dir: Optional[str] = None,
    log_budget_bytes: Optional[int] = None,
    layout: str = "ell",
    device="cuda",
    trace: Optional[Dict] = None,
):
    """Adjacency → normalized Laplacian → walks → consolidated ELL step
    matrices on ``device``, cached on disk under ``cache_dir``.

    When the monolithic (L, N, W) walk log would exceed ``log_budget_bytes``
    the blocked pipeline walks start-node blocks instead; blocking never
    changes the result.

    ``layout="auto"`` converts the ELL matrices to the stencil layout
    (structured graphs: ring, grid, torus) with kernel K3 and returns
    StencilFeatures; where the offset vocabulary is too large (unstructured
    graphs) it returns EllFeatures with the column-sorted transpose attached.
    ``layout="ell"`` returns EllFeatures. ``trace``, when given, receives the
    seconds of the walk+consolidate, stencil conversion (``stencil_build_s``),
    or of the offset scan that rules the stencil out (``vocabulary_s``) and
    the transpose (``transpose_s``), each ended by a device
    synchronize, and the intermediate ELL step matrices (``"ell"``). The
    seconds are the readings of the recorder's ``prep.pack_laplacian``,
    ``prep.layout`` and ``prep.transpose`` spans (``utils.profiling``) to
    the end of that synchronize.
    """
    with profiling.span("prep.build"):
        if layout not in ("ell", "auto"):
            raise ValueError(f"unknown layout {layout!r}; expected 'ell' or 'auto'")
        dev = resolve_device(device)
        budget = DEFAULT_LOG_BUDGET_BYTES if log_budget_bytes is None else log_budget_bytes
        base = None
        if cache_dir is not None:
            base = os.path.join(cache_dir, f"step_matrices_{_cache_key(adjacency, cfg, seed)}")
            if os.path.exists(base + ".npz"):
                if layout == "auto":
                    cached = _load_layout_sidecar(base, dev)
                    if cached is not None:
                        return cached
                return _apply_layout(load_step_matrices(base + ".npz", dev), layout, base, trace)

        with profiling.timed("prep.pack_laplacian", trace is not None) as pack:
            graph = pack_laplacian(adjacency).to(dev)
        n = graph.num_nodes
        if cfg.max_walk_length * n * cfg.walks_per_node * 8 > budget:
            mats = blocked_ell_features(
                graph, seed, cfg, log_budget_bytes=budget, device=dev
            ).mats
        else:
            with profiling.span("prep.walks"):
                log = sample_walk_log(graph, seed, cfg)
            with profiling.span("prep.consolidate"):
                mats = consolidate(log, suggest_row_capacity(log),
                                   walks_per_node=cfg.walks_per_node)
            del log
        _record(trace, "walk_consolidate_s", pack, dev)
        if trace is not None:
            trace["ell"] = mats
        if base is not None:
            save_step_matrices(base + ".npz", mats)
        return _apply_layout(mats, layout, base, trace)


def _record(trace, name, start: profiling.Span, dev) -> None:
    """``trace[name]``: the seconds from ``start``'s first reading to the end
    of a device synchronize, so the phase holds the device work it queued."""
    if trace is not None:
        with profiling.timed("sync") as done:
            if dev.type == "cuda":
                profiling.count("host.syncs")
                torch.cuda.synchronize(dev)
        trace[name] = (done.end_ns - start.start_ns) * 1e-9


def _load_layout_sidecar(base: str, device):
    """Load a cached derived layout (stencil, or ELL + transpose) if present."""
    spath = base + ".stencil.npz"
    if os.path.exists(spath):
        with np.load(spath) as z:
            return StencilFeatures(
                StencilStepMatrices(
                    vals=torch.from_numpy(z["vals"]).to(device),
                    offsets=np.asarray(z["offsets"], np.int32),
                )
            )
    cpath = base + ".csc.npz"
    if os.path.exists(cpath):
        mats = load_step_matrices(base + ".npz", device)
        with np.load(cpath) as z:
            csc = CscStepMatrices(*(torch.from_numpy(z[k]).to(device) for k in CSC_FIELDS))
        return EllFeatures(mats, csc)
    return None


def _apply_layout(mats: EllStepMatrices, layout: str, base: Optional[str], trace=None):
    """ELL step matrices → requested layout. ``auto`` converts to stencil
    when the offset vocabulary is small and otherwise attaches the
    column-sorted transpose, saving a ``.stencil.npz`` or ``.csc.npz``
    sidecar next to the ELL cache."""
    if layout != "auto":
        return EllFeatures(mats)
    with profiling.timed("prep.layout", trace is not None) as phase:
        max_offsets = min(256, max(64, int(mats.num_nodes ** 0.5)))
        stencil = ell_to_stencil(mats, max_offsets=max_offsets)
        if stencil is not None:
            _record(trace, "stencil_build_s", phase, stencil.vals.device)
            if base is not None:
                np.savez(
                    base + ".stencil.npz",
                    vals=stencil.vals.cpu().numpy(),
                    offsets=np.asarray(stencil.offsets),
                )
            return StencilFeatures(stencil)
        _record(trace, "vocabulary_s", phase, mats.cols.device)
        with profiling.timed("prep.transpose", trace is not None) as transpose:
            feats = with_transpose(EllFeatures(mats))
            _record(trace, "transpose_s", transpose, mats.cols.device)
        if base is not None:
            np.savez(
                base + ".csc.npz", **{k: getattr(feats.csc, k).cpu().numpy() for k in CSC_FIELDS}
            )
        return feats
