"""Seconds per GP fit (30 Adam steps of the CG marginal likelihood), the mean
of ``GRFThompson.phase_seconds["fit"]`` over the window's fits; in the cells
whose rate is ``bo_iter_s``."""
from gpbench.core import readers

LAYER = "GP"
UNIT = "s"
SOURCE = "program_span"
MOVES = "bo_iter_s"

read = readers.fit_mean
