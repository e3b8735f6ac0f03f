"""The stencil products' and weight gradients' share of their roofline:
the least time for the bytes and operations the calls need (counted at the
operator's call sites, ``core/peaks.stencil_work``), over the device time of
everything those calls launched. K1 and dw today."""
from gpbench.core import peaks

LAYER = "operator"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "bo_iter_s.b100"


def read(ctx):
    c, t = ctx["probes"].counters, ctx["trace"]
    if not t or not c.get("calls.k1"):
        return None
    return peaks.share_percent(c["bytes.k1"], c["flops.k1"], t["device_s_by_span"].get("k1", 0.0))
