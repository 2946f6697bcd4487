from diffpure_tpu_torch.solvers.em import brownian_increment, sdeint_em
