"""The ``host:`` line's sampler: it runs beside the window, is stopped and
waited for when the window ends, also when the window raises, and the line
carries the window's CPU share and the loop's samples."""
import time

import pytest

from gpbench.core import host


def test_the_sampler_ends_with_the_window_and_reports_its_samples():
    with host.Beside() as beside:
        time.sleep(1.2)
    assert beside.proc.poll() is not None
    assert beside.before is not None and len(beside.samples) >= 2
    line = beside.describe()
    assert line.startswith("host: window ") and f"over {len(beside.samples)} samples" in line


def test_the_sampler_ends_when_the_window_raises():
    with pytest.raises(RuntimeError, match="window"):
        with host.Beside() as beside:
            raise RuntimeError("window")
    assert beside.proc.poll() is not None
