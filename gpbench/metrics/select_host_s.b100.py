"""Host seconds per BO iteration outside the fit and the draw: the benchmark's
span around ``select_next_points`` less the program's fit and draw phases
inside it (padding, uploads, exclusion, top-k), per iteration; in the cells
whose rate is ``bo_iter_s.b100``."""
from gpbench.core import readers

LAYER = "BO algorithm"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "bo_iter_s.b100"

read = readers.select_host
