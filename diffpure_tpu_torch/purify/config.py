"""Static configuration for the purification runners.

Carried over unchanged (diffpure_tpu/purify/config.py) so that one config
object describes a run in either package. The port implements
``diffusion_type`` 'sde', 'ode', 'ldsde' and 'dpm' with ``score_type``
'score_sde' and 'guided_diffusion'; the runners raise on the other values.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PurifyConfig:
    # runner selection (ref eval_sde_adv.py:44-55)
    diffusion_type: str = "sde"  # sde | ode | ldsde | ddpm | celebahq-ddpm

    # forward-diffusion depth: integer step count, continuous time = t/1000
    # (ref runners/diffpure_sde.py:228-231)
    t: int = 100
    rand_t: bool = False
    t_delta: int = 15
    sample_step: int = 1
    # fix_rand: one shared forward-noise tile across the batch
    # (ref runners/diffpure_ode.py:202-209)
    fix_rand: bool = False

    # score adapter (ref --score_type)
    score_type: str = "score_sde"  # score_sde | guided_diffusion
    learn_sigma: bool = True  # guided_diffusion 6-channel output

    # VP-SDE parameters (ref diffpure_sde.py:50-80)
    beta_min: float = 0.1
    beta_max: float = 20.0
    N: int = 1000

    # solver steps: None -> t steps (torchsde default dt=1e-3 over span
    # t/1000, ref SURVEY.md §3.2); pass fewer for accelerated purification.
    n_steps: int | None = None

    # ODE runner (ref diffpure_ode.py:229-238)
    step_size: float = 1e-3
    ode_method: str = "euler"  # 'euler' | 'heun'

    # LDSDE runner (ref diffpure_ldsde.py:50-130,195-199)
    sigma2: float = 1e-3
    lambda_ld: float = 1e-2
    eta: float = 5.0
    ldsde_dt: float = 1e-2
    ldsde_t: float = 1e-2

    # gradients through purification: 'checkpoint' | 'adjoint' |
    # 'reversible' | 'none'
    grad_mode: str = "checkpoint"

    # numerical epsilon at the integration end (ref diffpure_sde.py:228)
    epsilon_dt1: float = 1e-5

    def solver_steps(self) -> int:
        return self.n_steps if self.n_steps is not None else self.t
