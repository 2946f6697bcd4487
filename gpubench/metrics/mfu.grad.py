"""mfu.grad: The model FLOPs the window's calls need (configs/<config>.json's flops), over the window's wall time and the dtype's dense peak."""
from gpubench.lib import readers

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = "grad_img_per_s"


def read(t):
    return readers.mfu(t, "eotgrad")
