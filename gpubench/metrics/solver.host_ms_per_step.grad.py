"""solver.host_ms_per_step.grad: Host milliseconds a solver step spends outside the score model (its backward included) and the classifier: purify_sde / sdeint_em's own work."""
from gpubench.lib import readers

LAYER = "solver"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "grad_img_per_s"


def read(t):
    return readers.host_ms_per_step(t, "eotgrad")
