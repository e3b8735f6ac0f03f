"""Share of the traced window of feature builds in which no operation ran on the device:
1 - (union of device activity) / (window)."""
from gpbench.core import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "features_s"

read = readers.idle_percent
