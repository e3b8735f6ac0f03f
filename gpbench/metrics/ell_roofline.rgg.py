"""The ELL forward and column-sorted transposed products' share of their
roofline, read as ``ell_roofline`` reads it (Φ's live entries and the
vectors each call needs, ``core/peaks.sparse_work``, over the device time of
everything the calls launched); in the random geometric graph's batch-100
cell, whose draws run these products over 10^6 rows."""
from gpbench.core import peaks

LAYER = "operator"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "bo_iter_s.b100"


def read(ctx):
    c, t = ctx["probes"].counters, ctx["trace"]
    if not t or not c.get("calls.ell"):
        return None
    return peaks.share_percent(c["bytes.ell"], c["flops.ell"],
                               t["device_s_by_span"].get("ell", 0.0))
