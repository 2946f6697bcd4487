#!/usr/bin/env bash
# PyTorch port of run_scripts/cifar10/run_cifar_rand_L2_rn50_eps1.sh (same flags;
# ref run_scripts/cifar10/run_cifar_rand_L2_rn50_eps1.sh), on the CUDA card.
# Usage: bash run_cifar_rand_L2_rn50_eps1.sh [seed_id] [data_id]
cd "$(dirname "$0")/../../.."

SEED=${1:-0}
DATA_SEED=${2:-0}

python -m diffpure_tpu_torch.cli \
  --exp ./exp_results \
  --seed $SEED \
  --data_seed $DATA_SEED \
  --config cifar10.yml \
  --domain cifar10 \
  --diffusion_type sde \
  --score_type score_sde \
  --adv_batch_size 64 \
  --num_sub 64 \
  --t 125 \
  --adv_eps 1.0 \
  --lp_norm L2 \
  --classifier_name cifar10-resnet-50 \
  --attack_version rand \
  --eot_iter 20
