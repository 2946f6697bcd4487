"""device.idle_share.purify: 1 - (union of the device's operation intervals) / the window's wall time."""
from gpubench.lib import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "purify_img_per_s"


def read(t):
    return readers.idle_share(t, "purify")
