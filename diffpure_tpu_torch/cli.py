"""Command-line entry point, the eval_sde_adv / eval_sde_adv_bpda counterpart
(port of diffpure_tpu/cli.py; ref eval_sde_adv.py:211-323,
eval_sde_adv_bpda.py:177-279):

    python -m diffpure_tpu_torch.cli --config cifar10.yml --domain cifar10 ...

Builds the defended model from the YAML config and the checkpoints under
./pretrained/ (score_sde/checkpoint_8.pth, guided_diffusion/
256x256_diffusion_uncond.pt, celebahq/celeba_hq.ckpt, classifiers/<name>.pt,
the CIFAR paths of ``CKPT_MAP`` or celebahq/<attribute>/net_best.pth),
loads the evaluation subset from ./dataset/ and runs the requested attack
protocol.
``--random_weights`` (or a missing checkpoint, with a warning) runs the
pipeline on seeded random weights: seeded normal ones for the ADM too,
where JAX's CLI gives it zeros (diffpure_tpu/cli.py:60-66), whose score is
identically zero, so that the kernels do real work. The models and the
data go to ``--device`` (default ``cuda``); ``cuda`` with no card raises.
The port runs the ``cifar10``, ``imagenet`` and ``celebahq`` domains; the
multi-GPU split waits for ROADMAP item 20.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from diffpure_tpu_torch.config import build_parser, load_config, make_log_dir
from diffpure_tpu_torch.utils import seed_everything, setup_run_logging
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

DOMAINS = ("cifar10", "imagenet", "celebahq")


def _check_domain(domain: str) -> None:
    if not any(d in domain for d in DOMAINS):
        raise NotImplementedError(f"unknown domain {domain!r}")


def _load_weights(model: torch.nn.Module, sd, device: torch.device) -> torch.nn.Module:
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return model.eval().requires_grad_(False).to(device)


def build_score_model(args, config, device: torch.device) -> torch.nn.Module:
    """The score model of the domain (ref eval_sde_adv.py:40-55, runners/
    diffpure_sde.py:160-190; JAX cli.py:26-84), built as the reference
    builds it: cifar10 the NCSN++ of ``config`` (its torso in bf16 under
    ``--precision bf16``), imagenet the ADM of the ``model:`` section
    (``adm_from_config``; its torso in bf16 where ``use_fp16`` says so),
    celebahq SDEdit's DDPM UNet at the widths of configs/celeba.yml (its
    torso in bf16 under ``--precision bf16``). Weights frozen: attacks
    differentiate the input."""
    from diffpure_tpu_torch.config import namespace2dict
    from diffpure_tpu_torch.models import DDPMUNet, adm_from_config, ncsnpp_from_config
    from diffpure_tpu_torch.models.convert import load_guided_diffusion_checkpoint, \
        load_score_sde_checkpoint, load_sdedit_checkpoint

    _check_domain(args.domain)
    dtype = torch.bfloat16 if args.precision == "bf16" else None
    if "imagenet" in args.domain:
        model = adm_from_config(namespace2dict(config.model))
        ckpt = "pretrained/guided_diffusion/256x256_diffusion_uncond.pt"
        load = lambda: load_guided_diffusion_checkpoint(ckpt, model)  # noqa: E731
    elif "celebahq" in args.domain:
        model = DDPMUNet(dtype=dtype)
        ckpt = "pretrained/celebahq/celeba_hq.ckpt"
        load = lambda: load_sdedit_checkpoint(ckpt, model)  # noqa: E731
    else:
        model = ncsnpp_from_config(config, dtype=dtype)
        ckpt = "pretrained/score_sde/checkpoint_8.pth"
        load = lambda: load_score_sde_checkpoint(ckpt)  # noqa: E731
    if args.random_weights or not os.path.exists(ckpt):
        sd = seeded_normal_state_dict(model, 0)
        if not args.random_weights:
            print(f"WARNING: {ckpt} missing; using random weights")
    else:
        sd = load()
    return _load_weights(model, sd, device)


# the CIFAR classifiers that the reference keeps beside its robustbench
# ones (JAX cli.py:97-108); the rest are pretrained/classifiers/<name>.pt
CKPT_MAP = {
    "cifar10-resnet-50": "pretrained/cifar10/resnet-50/weights.pt",
    "cifar10-wrn-70-16-dropout": "pretrained/cifar10/wrn-70-16-dropout/weights.pt",
    "cifar10-wideresnet-70-16": "pretrained/cifar10/wresnet-76-10/weights-best.pt",
}


def build_classifier(args, device: torch.device) -> torch.nn.Module:
    """Classifier taking [0, 1] NHWC images (ref utils.py:143-253), its
    publisher's keys (robustbench, torchvision, timm, the reference's CIFAR
    ResNet-50 and WRN-70-16, its CelebA-HQ attribute nets) from
    ``CKPT_MAP``, pretrained/celebahq/<attribute>/net_best.pth or
    pretrained/classifiers/<name>.pt. The seeded weights need no input size
    (JAX initialises ImageNet models at 224 px, cli.py:111-112): DeiT-S's
    position grid is its 224-px one either way."""
    from diffpure_tpu_torch.classifiers import get_classifier
    from diffpure_tpu_torch.classifiers.convert import attribute_state_dict
    from diffpure_tpu_torch.models.convert import load_torch_state_dict, \
        strip_module_prefix

    name = args.classifier_name
    model = get_classifier(name)
    if name.startswith("celebahq__"):
        ckpt = f"pretrained/celebahq/{name.split('__')[-1]}/net_best.pth"
    else:
        ckpt = CKPT_MAP.get(name, f"pretrained/classifiers/{name}.pt")
    if args.random_weights or not os.path.exists(ckpt):
        sd = seeded_normal_state_dict(model, 1)
        if not args.random_weights:
            print(f"WARNING: classifier ckpt {ckpt} missing; random weights")
    else:
        sd = load_torch_state_dict(ckpt)
        for key in ("state_dict", "model_state_dict"):
            if isinstance(sd, dict) and key in sd:
                sd = sd[key]
                break
        sd = attribute_state_dict(sd) if name.startswith("celebahq__") \
            else strip_module_prefix(sd)
    return _load_weights(model, sd, device)


def _attack_kwargs(args) -> dict:
    """The attack's config fields by version (JAX cli.py:187-207)."""
    if args.attack_version in ("standard", "rand", "custom"):
        return dict(norm=args.lp_norm, eps=args.adv_eps,
                    eot_iter=args.eot_iter if args.attack_version == "rand" else 1,
                    apgd_iters_per_dispatch=args.attack_dispatch_iters)
    if args.attack_version == "stadv":
        return dict(bound=args.adv_eps, n_iter=100, eot_iter=args.eot_iter,
                    iters_per_dispatch=args.attack_dispatch_iters)
    if args.attack_version == "bpda":
        return dict(adv_eps=args.adv_eps, adv_eta=args.adv_eta,
                    adv_steps=args.adv_steps,
                    eot_defense_reps=args.eot_defense_reps,
                    eot_attack_reps=args.eot_attack_reps,
                    defense_batch=args.eot_defense_batch,
                    attack_batch=args.eot_attack_batch,
                    attack_norm="l_inf" if args.lp_norm == "Linf" else "l_2")
    return {}


def main(argv=None) -> dict:
    parser = build_parser()
    parser.add_argument("--random_weights", action="store_true",
                        help="skip checkpoint loading (smoke test)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           f"available (pass --device cpu to run on the CPU)")
    config = load_config(args.config if os.path.exists(args.config)
                         else os.path.join("configs", args.config))

    log_dir = make_log_dir(args)
    setup_run_logging(log_dir, args.verbose)
    seed = seed_everything(args.seed)
    print(f"log dir: {log_dir}")

    from diffpure_tpu_torch.data import load_data
    from diffpure_tpu_torch.eval import DefendedModel, robustness_eval
    from diffpure_tpu_torch.purify import PurifyConfig
    from diffpure_tpu_torch.utils.profiling import count_nfe

    score = build_score_model(args, config, device)
    classifier = build_classifier(args, device)
    purify_cfg = PurifyConfig(
        diffusion_type=args.diffusion_type, t=args.t, rand_t=args.rand_t,
        t_delta=args.t_delta, sample_step=args.sample_step,
        score_type=args.score_type, step_size=args.step_size,
        sigma2=args.sigma2, lambda_ld=args.lambda_ld, eta=args.eta,
        n_steps=args.solver_steps,
        grad_mode="none" if args.attack_version == "bpda" else args.grad_mode)
    defended = DefendedModel(score, classifier, purify_cfg,
                             resize_to=256 if "imagenet" in args.domain else None)

    x_np, y_np = load_data(args.domain, args.num_sub, args.data_seed,
                           classifier_name=args.classifier_name,
                           adv_batch_size=args.adv_batch_size)
    x = torch.from_numpy(x_np).to(device)
    y = torch.from_numpy(y_np.astype(np.int64)).to(device)
    print(f"x: {tuple(x.shape)} [{float(x.min()):.3f}, {float(x.max()):.3f}] "
          f"on {device}")

    with count_nfe() as nfe:
        results = robustness_eval(defended, x, y, seed, args.attack_version,
                                  log_dir=log_dir, **_attack_kwargs(args))
    print(nfe.report())
    shown = {k: v for k, v in results.items() if k != "x_adv"}
    print(f"results: {shown}")
    return results


if __name__ == "__main__":
    main()
