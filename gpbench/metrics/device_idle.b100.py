"""Share of the traced BO window in which no operation ran on the device:
1 - (union of device activity) / (window); in the cells whose rate is
``bo_iter_s.b100``."""
from gpbench.core import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "bo_iter_s.b100"

read = readers.idle_percent
