"""The numbers that decide ``correct``: each a gap between what the program
produced and what the plain reference works out from the same inputs.

A record (built by the harness once the window has closed) holds the
program's outputs at positions drawn from the seed, and the inputs: the
adjacency, the walk settings and seed, the objective values, the random
draws the program consumed (probes, ε₁, ε₂). The reference recomputes the
walks of every row it needs, so it takes no table the program made.

``numbers(record, device)`` judges the program. ``numbers(record, device,
control=True)`` puts the reference, computed in bfloat16, in the program's
place: the control that every limit must catch.

Each number, and what it covers:

* ``ell``, ``stencil``: step-matrix entries at sampled rows, in the ELL
  rows the walks were consolidated into and in the stencil layout built
  from them, largest gap over a row and step as a share of that row and
  step's largest entry;
* ``csc``: the column-sorted transpose at sampled columns, likewise;
* ``phi``: the window's last forward and transposed Φ products, at the
  fitted modulator, at sampled rows and columns, as a share of the sum of
  the absolute terms;
* ``logdet``: the log-determinant inside the first objective value of the
  last run's first fit (the objective less the quadratic of the program's
  solve) against SLQ on the same probes, as a share of the quadrature's
  sum of absolute terms;
* ``quad_drift``, ``draw_drift``: how far the relative residual of the
  program's solves (the objective's quadratic, the last Thompson draw's)
  under the reference's operator in float64 lies from the residual that
  the program's CG reports and stops on; the control's is that gap of a
  bfloat16 CG under the configuration's stopping rule (the residuals
  themselves, ``quad_res`` and ``draw_res``, are readings for the record);
* ``cg_stop``: judged solves that stopped before ``cg_max_iters`` with a
  reported residual above ``cg_tol`` (exact: 0);
* ``grad``: the gradient of that first objective as Adam gets it (K1's dw
  or the ELL's transposed products, the adjoint CG solve, the probe
  solves), against the same estimator with exact float64 solves on the
  same probes: by the worst leaf, the norm of the difference over the
  larger of the leaf's and the median leaf's norm;
* ``step``: the parameters' change at that fit's first Adam step against
  Adam's first step from the reference's gradient: by the worst leaf, the
  gap of the norms over the larger of the leaf's and the median leaf's
  (a leaf whose reference gradient is under a thousandth of the median
  leaf's is left out: round-off alone moves it);
* ``train_set``: live observation slots of the judged fit, refit and draw
  that are not the observed set of their ``select`` (exact: 0);
* the same ``logdet``, ``quad_drift``, ``grad`` and ``step`` of the last
  run's last refit, named ``<number>.refit``; a cell compares those its
  limits name;
* ``draw``: the last Thompson draw at sampled nodes and at the picks,
  assembled from ε₁ and the program's solve, as a share of the absolute
  terms;
* ``pick``: picks that are not among the top ``k`` unobserved scores of the
  program's draw, plus picks of observed nodes and repeats (exact: 0).
"""
from __future__ import annotations

import math
import statistics
from collections import Counter

import numpy as np
import torch

from . import gp as rgp
from . import grf

LOG_2PI = math.log(2.0 * math.pi)


def _rel(num, den) -> float:
    return float(num) / max(float(den), 1e-30)


def _entry_gap(prog_cols, prog_vals, ref_cols, ref_vals) -> float:
    """Largest |program − reference| over the union of columns, as a share of
    the reference's largest |entry| (entries of value 0 count as absent)."""
    keep = prog_vals != 0
    p = dict(zip(prog_cols[keep].tolist(), prog_vals[keep].astype(np.float64).tolist()))
    r = dict(zip(ref_cols.tolist(), ref_vals.tolist()))
    scale = max((abs(v) for v in r.values()), default=0.0)
    worst = max((abs(p.get(c, 0.0) - r.get(c, 0.0)) for c in set(p) | set(r)), default=0.0)
    if scale == 0.0:
        return 0.0 if worst == 0.0 else 1.0
    return worst / scale


class _Rows:
    """Reference step rows for a set of global rows, looked up by node id."""

    def __init__(self, rec, rows, device, dtype):
        wk = rec["walks"]
        self.lap = grf.laplacian(rec["adjacency"]).to(device)
        self.rows = np.unique(np.asarray(rows, dtype=np.int64))
        self.m = grf.step_rows(self.lap, self.rows, wk["seed"], wk["walks_per_node"],
                               wk["p_halt"], wk["length"], dtype=dtype)
        self.local = {int(r): k for k, r in enumerate(self.rows)}
        self.device = device
        self.dtype = dtype

    def _local(self, nodes) -> torch.Tensor:
        return torch.as_tensor([self.local[int(n)] for n in np.asarray(nodes).ravel()],
                               dtype=torch.int64, device=self.device)

    def support(self, nodes) -> np.ndarray:
        """Sorted columns where Φ's rows at ``nodes`` hold an entry."""
        keep = torch.zeros(len(self.rows), dtype=torch.bool, device=self.device)
        keep[self._local(nodes)] = True
        cols = [m.indices()[1][keep[m.indices()[0]]] for m in self.m.steps]
        return torch.unique(torch.cat(cols)).cpu().numpy()

    def phi(self, nodes, cols, f) -> torch.Tensor:
        """Φ = Σ_l f_l M_l at rows ``nodes`` (repeats allowed) and columns
        ``cols``, dense, summed in this reference's dtype."""
        uniq, inv = np.unique(np.asarray(nodes, dtype=np.int64).ravel(), return_inverse=True)
        row_lut = torch.full((len(self.rows),), -1, dtype=torch.int64, device=self.device)
        row_lut[self._local(uniq)] = torch.arange(len(uniq), device=self.device)
        col_lut = torch.full((self.m.num_nodes,), -1, dtype=torch.int64, device=self.device)
        col_lut[torch.as_tensor(np.asarray(cols), device=self.device)] = torch.arange(
            len(cols), device=self.device)
        f = f.to(device=self.device, dtype=self.dtype)
        dense = torch.zeros((len(uniq), len(cols)), dtype=self.dtype, device=self.device)
        for step, m in enumerate(self.m.steps):
            ix, v = m.indices(), m.values()
            r, c = row_lut[ix[0]], col_lut[ix[1]]
            sel = (r >= 0) & (c >= 0)
            dense.index_put_((r[sel], c[sel]), f[step] * v[sel], accumulate=True)
        return dense[torch.as_tensor(inv, device=self.device)]

    def phi_steps(self, nodes, cols) -> torch.Tensor:
        """(L, len(nodes), len(cols)): each step's rows at distinct ``nodes``
        and columns ``cols``, dense, in this reference's dtype."""
        nodes = np.asarray(nodes, dtype=np.int64).ravel()
        row_lut = torch.full((len(self.rows),), -1, dtype=torch.int64, device=self.device)
        row_lut[self._local(nodes)] = torch.arange(len(nodes), device=self.device)
        col_lut = torch.full((self.m.num_nodes,), -1, dtype=torch.int64, device=self.device)
        col_lut[torch.as_tensor(np.asarray(cols), device=self.device)] = torch.arange(
            len(cols), device=self.device)
        out = torch.zeros((len(self.m.steps), len(nodes), len(cols)), dtype=self.dtype,
                          device=self.device)
        for step, m in enumerate(self.m.steps):
            ix, v = m.indices(), m.values()
            r, c = row_lut[ix[0]], col_lut[ix[1]]
            sel = (r >= 0) & (c >= 0)
            out[step].index_put_((r[sel], c[sel]), v[sel], accumulate=True)
        return out

    def column(self, c, step):
        """(rows, values) of column ``c`` at ``step`` over the held rows."""
        mat = self.m.steps[step]
        ix, v = mat.indices(), mat.values()
        sel = ix[1] == int(c)
        return self.rows[ix[0][sel].cpu().numpy()], v[sel].cpu().to(torch.float64).numpy()


def _needed_rows(rec):
    rows = [rec["sample_rows"]]
    if rec.get("draw"):
        d = rec["draw"]
        rows += [d["train_idx"], d["rows"]]
    for part in ("fit", "refit"):
        if rec.get(part):
            rows.append(rec[part]["train_idx"])
    if rec.get("csc_cols") is not None or rec.get("phi"):
        rows.append(grf.within_hops(rec["adjacency"], rec["sample_cols"],
                                    rec["walks"]["length"] - 1))
    return np.concatenate([np.asarray(r, dtype=np.int64).ravel() for r in rows])


def _rows_gap(rec, ref, low, layout: str):
    """Largest entry gap over sampled rows and steps of one layout's rows."""
    worst = 0.0
    n = ref.m.num_nodes
    for k, node in enumerate(rec["sample_rows"]):
        for step in range(rec["walks"]["length"]):
            rc, rv = ref.m.row_entries(ref.local[int(node)], step)
            if low is not None:
                pc, pv = low.m.row_entries(low.local[int(node)], step)
                pv = pv.astype(np.float32)
            elif layout == "stencil_rows":
                st = rec["stencil_rows"]
                pc = (int(node) + st["offsets"].astype(np.int64)) % n
                pv = st["vals"][step, :, k]
            else:
                pc = rec["ell_rows"]["cols"][step, k].astype(np.int64)
                pv = rec["ell_rows"]["vals"][step, k]
            worst = max(worst, _entry_gap(pc, pv, rc, rv))
    return worst


def _csc(rec, ref, low):
    worst = 0.0
    for k, c in enumerate(rec["sample_cols"]):
        for step in range(rec["walks"]["length"]):
            rr, rv = ref.column(c, step)
            if low is not None:
                pr, pv = low.column(c, step)
                pv = pv.astype(np.float32)
            else:
                pr, pv = rec["csc_cols"][k][step]
            worst = max(worst, _entry_gap(np.asarray(pr, np.int64), np.asarray(pv), rr, rv))
    return worst


def _observed(rec, idx, mask, device) -> torch.Tensor:
    """The objective at the observation slots, 0 in padded ones."""
    y = torch.as_tensor(np.asarray(rec["objective"], dtype=np.float64)[np.asarray(idx)],
                        device=device)
    return y * mask


def _modulator(params) -> torch.Tensor:
    if "modulator" not in params:
        raise ValueError("the reference states the free modulator only")
    return params["modulator"].detach().to(torch.float64).cpu()


def _noise_var(params) -> float:
    raw = float(params["raw_noise"])
    return math.log1p(math.exp(-abs(raw))) + max(raw, 0.0) + 1e-6


def _phi(rec, ref, low, device):
    """Forward products at sampled rows, transposed ones at sampled columns."""
    ph = rec["phi"]
    f = _modulator(ph["params"])
    worst = 0.0
    for kind, key in (("forward", "sample_rows"), ("transposed", "sample_cols")):
        if ph.get(kind) is None:
            continue
        v, out = ph[kind]
        at = np.asarray(rec[key])
        if kind == "forward":
            inner = ref.support(at)
            ref_mat = ref.phi(at, inner, f).T  # (inner, at)
        else:
            inner = grf.within_hops(rec["adjacency"], at, rec["walks"]["length"] - 1)
            ref_mat = ref.phi(inner, at, f)
        vv = v[:, torch.as_tensor(inner, device=v.device)].to(device=device, dtype=torch.float64)
        exp = vv @ ref_mat
        absterm = vv.abs() @ ref_mat.abs()
        if low is not None:
            low_mat = low.phi(at, inner, f).T if kind == "forward" else low.phi(inner, at, f)
            got = (vv.to(low.dtype) @ low_mat).to(torch.float64)
        else:
            got = out[:, torch.as_tensor(at, device=out.device)].to(device=device,
                                                                  dtype=torch.float64)
        worst = max(worst, _rel((got - exp).abs().max(), absterm.max()))
    return worst


def _live(part) -> tuple:
    """(slots, nodes) of the live observation slots."""
    slots = np.nonzero(np.asarray(part["mask"]) > 0)[0]
    return slots, np.asarray(part["train_idx"], dtype=np.int64)[slots]


def train_set_gap(part) -> int:
    """Live slots' nodes that are not the observed set, and observed nodes
    that no live slot holds (counted with multiplicity)."""
    _, live = _live(part)
    got, want = Counter(live.tolist()), Counter(np.asarray(part["observed"]).tolist())
    return sum(((got - want) + (want - got)).values())


def _stopped_early(rec, part) -> bool:
    """A solve that reports a residual above ``cg_tol`` and yet stopped
    before ``cg_max_iters``: its stopping rule is not the configuration's."""
    p, solver = rec[part], rec["solver"]
    return p["recurrence"] > solver["cg_tol"] and p["iterations"] < solver["cg_max_iters"]


def _worst_leaf(got: dict, exp: dict, norms_only: bool, keep=None) -> float:
    """The worst leaf's gap, over the larger of the leaf's and the median
    leaf's reference norm: of the norms (``norms_only``) or the norm of the
    difference."""
    norm = lambda t: float(torch.linalg.vector_norm(t.to(torch.float64).cpu()))  # noqa: E731
    ref = {k: norm(v) for k, v in exp.items()}
    med = statistics.median(ref.values())
    worst = 0.0
    for k in exp:
        if keep is not None and k not in keep:
            continue
        g, e = got[k].to(torch.float64).cpu(), exp[k].to(torch.float64).cpu()
        gap = abs(norm(g) - ref[k]) if norms_only else norm(g - e)
        worst = max(worst, gap / max(ref[k], med, 1e-30))
    return worst


def _fit(rec, ref, low, device, part):
    """``logdet``, ``quad_drift`` (and the residual ``quad_res``), ``grad``
    and ``step`` of one captured fit's first objective."""
    fit = rec[part]
    f = _modulator(fit["params"])
    nv = _noise_var(fit["params"])
    idx = np.asarray(fit["train_idx"])
    cols = ref.support(idx)
    phi_t = ref.phi(idx, cols, f)
    mask = fit["mask"].to(device=device, dtype=torch.float64)
    a = rgp.masked_operator(phi_t, nv, mask)
    probes = fit["probes"].to(device)
    exp, scale = rgp.slq_logdet(a, probes, fit["lanczos_iters"])
    y = _observed(rec, idx, mask, device)
    solver = rec["solver"]
    out = {}

    slots, live = _live(fit)
    lcols = ref.support(live)
    y_live = y[torch.as_tensor(slots, device=device)]
    z_live = probes[:, torch.as_tensor(slots, device=device)]
    g_ref = rgp.first_gradient(ref.phi_steps(live, lcols), fit["params"], y_live, z_live)
    step_ref = rgp.adam_first_step(g_ref, solver["learning_rate"])
    if low is not None:
        a_low = rgp.masked_operator(low.phi(idx, cols, f), nv, mask.to(low.dtype))
        got, _ = rgp.slq_logdet(a_low, probes, fit["lanczos_iters"])
        x_low, rec_low = rgp.cg(a_low, y, solver["cg_tol"], solver["cg_max_iters"])
        out["quad_res"] = rgp.relative_residual(a, x_low, y)
        out["quad_drift"] = abs(out["quad_res"] - rec_low)
        g_got = rgp.first_gradient(low.phi_steps(live, lcols), fit["params"], y_live, z_live)
        step_got = rgp.adam_first_step(g_got, solver["learning_rate"])
    else:
        alpha = fit["alpha"].to(device=device, dtype=torch.float64)
        quad = float((fit["y"].to(torch.float32) * fit["alpha"].to(torch.float32)).sum())
        got = -2.0 * fit["mll"] - quad - fit["num_real"] * LOG_2PI
        out["quad_res"] = rgp.relative_residual(a, alpha, y)
        out["quad_drift"] = abs(out["quad_res"] - fit["recurrence"])
        g_got = fit["grad"]
        step_got = ({k: fit["params_after"][k].to(torch.float64) - fit["params"][k].to(
            torch.float64) for k in fit["params_after"]} if fit.get("params_after") else None)
    out["logdet"] = abs(got - exp) / max(scale, 1e-30)
    if set(g_got) == set(g_ref):
        out["grad"] = _worst_leaf(g_got, g_ref, norms_only=False)
    else:  # a leaf the program left without a gradient
        out["grad"] = 1.0
    if step_got is not None and set(step_got) == set(step_ref):
        gnorm = {k: float(torch.linalg.vector_norm(v)) for k, v in g_ref.items()}
        med = statistics.median(gnorm.values())
        keep = {k for k, v in gnorm.items() if v >= 1e-3 * med}
        out["step"] = _worst_leaf(step_got, step_ref, norms_only=True, keep=keep)
    return out


def _draw(rec, ref, low, device):
    """(draw gap, the solve's residual, its drift) at the last Thompson draw."""
    d = rec["draw"]
    f = _modulator(d["params"])
    nv = _noise_var(d["params"])
    idx = np.asarray(d["train_idx"])
    rows = np.asarray(d["rows"])
    cols = ref.support(np.concatenate([idx, rows]))
    cols_t = torch.as_tensor(cols, device=d["eps1"].device)
    eps1 = d["eps1"][:, cols_t].to(device=device, dtype=torch.float64)[0]
    x = d["x"].to(device=device, dtype=torch.float64).reshape(-1)
    mask = d["mask"].to(device=device, dtype=torch.float64)
    phi_t = ref.phi(idx, cols, f)
    phi_r = ref.phi(rows, cols, f)
    exp = phi_r @ eps1 + phi_r @ (phi_t.T @ x)
    absterm = phi_r.abs() @ eps1.abs() + phi_r.abs() @ (phi_t.abs().T @ x.abs())
    y = _observed(rec, idx, mask, device)
    eps2 = d["eps2"].to(device=device, dtype=torch.float64).reshape(-1)
    b = (y - (phi_t @ eps1 + math.sqrt(nv) * eps2)) * mask
    a = rgp.masked_operator(phi_t, nv, mask)
    if low is not None:
        dt = low.dtype
        pl, tl = low.phi(rows, cols, f), low.phi(idx, cols, f)
        got = (pl @ eps1.to(dt) + pl @ (tl.T @ x.to(dt))).to(torch.float64)
        a_low = rgp.masked_operator(tl, nv, mask.to(dt))
        solver = rec["solver"]
        x_low, rec_low = rgp.cg(a_low, b, solver["cg_tol"], solver["cg_max_iters"])
        res = rgp.relative_residual(a, x_low, b)
        return _rel((got - exp).abs().max(), absterm.max()), res, abs(res - rec_low)
    got = d["scores"][torch.as_tensor(rows)].to(device=device, dtype=torch.float64)
    res = rgp.relative_residual(a, x, b)
    return _rel((got - exp).abs().max(), absterm.max()), res, abs(res - d["recurrence"])


def _pick(rec, control: bool) -> float:
    """Picks outside the top-k unobserved scores, observed or repeated."""
    p = rec["pick"]
    scores = p["scores"].to(torch.float64).clone()
    picks = np.asarray(p["picks"], dtype=np.int64)
    observed = torch.as_tensor(np.asarray(p["observed"], dtype=np.int64))
    scores[observed] = -math.inf
    k = len(picks)
    if control:
        low = p["scores"].to(torch.bfloat16).to(torch.float64)
        low[observed] = -math.inf
        picks = torch.topk(low, k).indices.numpy()
    if k == 0:
        return 0.0
    kth = torch.topk(scores, k).values[-1]
    bad = int((scores[torch.as_tensor(picks)] < kth).sum())
    bad += int(np.isin(picks, observed.numpy()).sum()) + (k - np.unique(picks).size)
    return float(bad)


def numbers(rec, device, control: bool = False) -> dict:
    """Each number by name: the program's gaps, or with ``control`` the
    bfloat16 reference's in its place."""
    device = torch.device(device)
    need = _needed_rows(rec)
    ref = _Rows(rec, need, device, torch.float64)
    low = _Rows(rec, need, device, torch.bfloat16) if control else None
    out = {}
    for layout, name in (("ell_rows", "ell"), ("stencil_rows", "stencil")):
        if rec.get(layout) is not None:
            out[name] = _rows_gap(rec, ref, low, layout)
    if rec.get("csc_cols") is not None:
        out["csc"] = _csc(rec, ref, low)
    if rec.get("phi"):
        out["phi"] = _phi(rec, ref, low, device)
    parts = [p for p in ("fit", "refit", "draw") if rec.get(p)]
    if parts:
        out["train_set"] = 0.0 if control else float(sum(train_set_gap(rec[p]) for p in parts))
        out["cg_stop"] = 0.0 if control else float(sum(_stopped_early(rec, p) for p in parts))
    for part, suffix in (("fit", ""), ("refit", ".refit")):
        if rec.get(part):
            for name, value in _fit(rec, ref, low, device, part).items():
                out[name + suffix] = value
    if rec.get("draw"):
        out["draw"], out["draw_res"], out["draw_drift"] = _draw(rec, ref, low, device)
    if rec.get("pick"):
        out["pick"] = _pick(rec, control)
    return out


def diagnostics(rec) -> dict:
    """What the program reports of its own solves, for the record beside
    the compared numbers: CG iterations and the recurrence's final relative
    residual (the quantity its stopping rule reads)."""
    out = {}
    for part, name in (("fit", "quad"), ("refit", "quad.refit"), ("draw", "draw")):
        if rec.get(part) and rec[part].get("iterations") is not None:
            out[f"cg_iters.{name}"] = float(rec[part]["iterations"])
            out[f"cg_recurrence.{name}"] = float(rec[part]["recurrence"])
    return out
