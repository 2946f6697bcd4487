"""step.device_ms.purify: Device milliseconds of every operation in the window, a solver step."""
from gpubench.lib import readers

LAYER = "model step"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "purify_img_per_s"


def read(t):
    return readers.device_ms_per_step(t, "purify")
