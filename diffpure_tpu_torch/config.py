"""Two-level config: dataset YAML + experiment flags (port of
diffpure_tpu/config.py:28-119).

YAML files become recursive attribute namespaces (ref utils.py:97-105) and
the CLI's flags mirror the reference's (ref eval_sde_adv.py:245-281). The
run directory is exp/<image_folder>/<classifier>/<diffusion>_<version>/
seed<k>/data<j> (ref eval_sde_adv.py:212-216).
"""
from __future__ import annotations

import argparse
import os
from types import SimpleNamespace
from typing import Any, Dict

import yaml


def dict2namespace(config: Dict[str, Any]) -> SimpleNamespace:
    """Recursive dict -> attribute namespace."""
    ns = SimpleNamespace()
    for key, value in config.items():
        setattr(ns, key,
                dict2namespace(value) if isinstance(value, dict) else value)
    return ns


def namespace2dict(ns) -> Dict[str, Any]:
    out = {}
    for k, v in vars(ns).items():
        out[k] = namespace2dict(v) if isinstance(v, SimpleNamespace) else v
    return out


def load_config(path: str) -> SimpleNamespace:
    with open(path) as f:
        return dict2namespace(yaml.safe_load(f))


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags and defaults, and ``--device``."""
    p = argparse.ArgumentParser(description="diffpure-tpu robustness eval "
                                            "(PyTorch port)")
    p.add_argument("--config", type=str, required=True,
                   help="dataset YAML under configs/")
    p.add_argument("--data_seed", type=int, default=0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--exp", type=str, default="exp")
    p.add_argument("--verbose", type=str, default="info")
    p.add_argument("--image_folder", type=str, default="images")
    p.add_argument("--ni", action="store_true",
                   help="no interaction (SLURM-friendly)")
    p.add_argument("--sample_step", type=int, default=1)
    p.add_argument("--t", type=int, default=400)
    p.add_argument("--t_delta", type=int, default=15)
    p.add_argument("--rand_t", action="store_true")
    p.add_argument("--diffusion_type", type=str, default="sde",
                   choices=["sde", "ode", "ldsde", "ddpm", "celebahq-ddpm",
                            "dpm"])  # dpm = DPM-Solver++(2M)
    p.add_argument("--score_type", type=str, default="guided_diffusion",
                   choices=["guided_diffusion", "score_sde"])
    p.add_argument("--eot_iter", type=int, default=20)
    p.add_argument("--use_bm", action="store_true")
    # LDSDE
    p.add_argument("--sigma2", type=float, default=1e-3)
    p.add_argument("--lambda_ld", type=float, default=1e-2)
    p.add_argument("--eta", type=float, default=5.0)
    p.add_argument("--step_size", type=float, default=1e-3)
    # adv
    p.add_argument("--domain", type=str, default="celebahq")
    p.add_argument("--classifier_name", type=str, default="Eyeglasses")
    p.add_argument("--partition", type=str, default="val")
    p.add_argument("--adv_batch_size", type=int, default=64)
    p.add_argument("--attack_type", type=str, default="square")
    p.add_argument("--lp_norm", type=str, default="Linf",
                   choices=["Linf", "L2"])
    p.add_argument("--attack_version", type=str, default="standard")
    p.add_argument("--num_sub", type=int, default=1000)
    p.add_argument("--adv_eps", type=float, default=0.07)
    # BPDA+EOT (ref eval_sde_adv_bpda.py argparse, bpda_eot_attack.py:24-34)
    p.add_argument("--adv_eta", type=float, default=2 / 255)
    p.add_argument("--adv_steps", type=int, default=50)
    p.add_argument("--eot_defense_reps", type=int, default=150)
    p.add_argument("--eot_attack_reps", type=int, default=15)
    p.add_argument("--eot_defense_batch", type=int, default=30,
                   help="defense reps purified per call (BPDA vote)")
    p.add_argument("--eot_attack_batch", type=int, default=0,
                   help="attack-EOT reps purified per call (0 = all in one)")
    p.add_argument("--solver_steps", type=int, default=None,
                   help="score evals for the accelerated solvers "
                        "(diffusion_type=dpm); default = t")
    p.add_argument("--attack_dispatch_iters", type=int, default=0,
                   help="kept for the JAX package's flag set: it bounds "
                        "device dispatches there and changes nothing here")
    p.add_argument("--precision", type=str, default="fp32",
                   choices=["fp32", "bf16"],
                   help="score-model torso precision for the cifar10 path "
                        "(fp32 = reference-faithful; bf16 = the serving "
                        "config)")
    p.add_argument("--grad_mode", type=str, default="checkpoint",
                   choices=["checkpoint", "adjoint", "reversible", "none"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the models and data; 'cuda' with "
                        "no card raises (pass 'cpu' to run on the CPU)")
    return p


def make_log_dir(args) -> str:
    """ref eval_sde_adv.py:212-216."""
    return os.path.join(
        args.exp, args.image_folder, args.classifier_name,
        f"{args.diffusion_type}_{args.attack_version}",
        f"seed{args.seed}", f"data{args.data_seed}")
