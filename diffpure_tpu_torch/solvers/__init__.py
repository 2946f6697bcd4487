from diffpure_tpu_torch.solvers.adjoint import sdeint_em_adjoint
from diffpure_tpu_torch.solvers.em import brownian_increment, sdeint_em
from diffpure_tpu_torch.solvers.dpm import dpm_solver_pp_2m
