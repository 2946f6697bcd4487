from diffpure_tpu_torch.solvers.adjoint import odeint_euler_adjoint, sdeint_em_adjoint
from diffpure_tpu_torch.solvers.em import brownian_increment, sdeint_em
from diffpure_tpu_torch.solvers.dpm import dpm_solver_pp_2m
from diffpure_tpu_torch.solvers.ode import odeint_euler, odeint_heun
from diffpure_tpu_torch.solvers.reversible import odeint_reversible_heun, \
    sdeint_reversible_heun
