"""step.kernels.purify: Device operations of every kind launched in the window, a solver step."""
from gpubench.lib import readers

LAYER = "model step"
UNIT = "kernels/step"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "purify_img_per_s"


def read(t):
    return readers.kernels_per_step(t, "purify")
