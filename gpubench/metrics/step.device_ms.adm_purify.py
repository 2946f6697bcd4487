"""step.device_ms.adm_purify: Device milliseconds of every operation in the window, a solver step."""
from gpubench.lib import readers

LAYER = "model step"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "adm_purify_img_per_s"


def read(t):
    return readers.device_ms_per_step(t, "purify")
