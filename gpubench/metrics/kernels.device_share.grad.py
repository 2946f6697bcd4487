"""kernels.device_share.grad: The hand-written kernels' share of the window's device time; the rest is cuDNN, cuBLAS and plain ops."""
from gpubench.lib import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "grad_img_per_s"


def read(t):
    return readers.own_device_share(t, "eotgrad")
