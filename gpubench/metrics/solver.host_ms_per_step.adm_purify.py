"""solver.host_ms_per_step.adm_purify: Host milliseconds a solver step spends outside the score model (its backward included) and the classifier: purify_sde / sdeint_em's own work."""
from gpubench.lib import readers

LAYER = "solver"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "adm_purify_img_per_s"


def read(t):
    return readers.host_ms_per_step(t, "purify")
