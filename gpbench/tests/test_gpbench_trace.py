"""The trace's reduction on a hand-made trace: busy time as the union of
device intervals, device time by the span that launched it, idle gaps named
by the host span open at their start."""
import pytest

from gpbench.core import trace

CUDA, CPU = "cuda", "cpu"


class Ev:
    def __init__(self, dev, name, start, dur, corr, annotation=False):
        self.dev, self._name, self.start, self.dur, self.corr = dev, name, start, dur, corr
        self.annotation = annotation

    def device_type(self):
        return self.dev

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr

    def is_user_annotation(self):
        return self.annotation


def test_reduce_a_hand_made_trace():
    spans = {"window": [(0, 1000)], "fit": [(150, 600)], "k1": [(155, 200)],
             "draw": [(650, 900)]}
    events = [
        Ev(CPU, "cudaLaunchKernel", 160, 5, 1),   # inside k1
        Ev(CPU, "cudaLaunchKernel", 300, 5, 2),   # inside fit, outside k1
        Ev(CUDA, "stencil", 200, 100, 1),
        Ev(CUDA, "add", 250, 150, 2),             # overlaps the first: union 200..400
        Ev(CUDA, "copy", 700, 50, 3),             # no launch in the trace
        Ev(CUDA, "fit-annotation", 0, 1000, 4, annotation=True),
    ]
    s = trace.reduce(events, CUDA, spans)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx(250e-9)
    assert s["device_s_by_span"] == {"k1": pytest.approx(100e-9)}
    assert s["events"] == 3 and s["unmatched"] == 1
    assert s["device_ops"][0] == ["add", pytest.approx(150e-9)]
    # gaps, named at their middle: 0..200 (window), 400..700 (fit until 600), 750..1000 (draw)
    assert [g[0] for g in s["idle_gaps"]] == ["fit", "draw", "window"]
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx([300e-9, 250e-9, 200e-9])
