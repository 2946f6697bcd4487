"""device.peak_mem_gib.grad: torch.cuda.max_memory_allocated() over the timed window, after reset_peak_memory_stats()."""
from gpubench.lib import readers

LAYER = "device"
UNIT = "GiB"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "grad_img_per_s"


def read(t):
    return readers.peak_mem_gib(t, "eotgrad")
