"""step.device_ms.grad: Device milliseconds of every operation in the window, a solver step."""
from gpubench.lib import readers

LAYER = "model step"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "grad_img_per_s"


def read(t):
    return readers.device_ms_per_step(t, "eotgrad")
