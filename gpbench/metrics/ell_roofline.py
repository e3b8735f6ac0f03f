"""The ELL forward and column-sorted transposed products' share of their
roofline: the least time for Φ's live entries and the vectors each call
needs (``core/peaks.sparse_work``), over the device time of everything the
calls launched."""
from gpbench.core import peaks

LAYER = "operator"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "bo_iter_s"


def read(ctx):
    c, t = ctx["probes"].counters, ctx["trace"]
    if not t or not c.get("calls.ell"):
        return None
    return peaks.share_percent(c["bytes.ell"], c["flops.ell"],
                               t["device_s_by_span"].get("ell", 0.0))
