"""device.peak_mem_gib.purify: torch.cuda.max_memory_allocated() over the timed window, after reset_peak_memory_stats()."""
from gpubench.lib import readers

LAYER = "device"
UNIT = "GiB"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "purify_img_per_s"


def read(t):
    return readers.peak_mem_gib(t, "purify")
