"""What the per-layer metrics of ``metrics/`` read, shared where two
metrics read the same quantity in cells that report different end-to-end
metrics (``fit_s`` moves ``bo_iter_s``, ``fit_s.b100`` moves
``bo_iter_s.b100``). Each returns None where there is nothing to read."""
from __future__ import annotations


def _phase(ctx, name):
    values = ctx["probes"].captures.get("phase_seconds", {}).get(name, [])
    return sum(values) / len(values) if values else None


def fit_mean(ctx):
    """Mean of ``GRFThompson.phase_seconds["fit"]`` over the window's fits."""
    return _phase(ctx, "fit")


def draw_mean(ctx):
    """Mean of ``GRFThompson.phase_seconds["draw"]`` over the window's draws."""
    return _phase(ctx, "draw")


def select_host(ctx):
    """The benchmark's span around ``select_next_points`` less the fit and
    draw phases inside it, per iteration."""
    p = ctx["probes"]
    selects = p.span_seconds.get("select", [])
    phases = p.captures.get("phase_seconds", {})
    if not selects:
        return None
    rest = sum(selects) - sum(phases.get("fit", [])) - sum(phases.get("draw", []))
    return rest / len(selects)


def idle_percent(ctx):
    """1 − (union of device activity) / (traced window), in percent."""
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
