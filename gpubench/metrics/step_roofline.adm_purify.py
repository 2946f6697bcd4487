"""step_roofline.adm_purify: The score model's blocks' least time a step (counts/blocks.py over the census of the published widths, whatever route runs each block) over the step's device time."""
from gpubench.lib import readers

LAYER = "model step"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "adm_purify_img_per_s"


def read(t):
    return readers.step_roofline(t, "purify")
