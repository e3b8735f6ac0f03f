"""Seconds per Thompson draw (a pathwise posterior sample at every node), the
mean of ``GRFThompson.phase_seconds["draw"]`` over the window's draws; in
the cells whose rate is ``bo_iter_s``."""
from gpbench.core import readers

LAYER = "GP"
UNIT = "s"
SOURCE = "program_span"
MOVES = "bo_iter_s"

read = readers.draw_mean
