#!/usr/bin/env bash
# PyTorch port of run_scripts/imagenet/run_in_stand_inf_50-2.sh (same flags;
# ref run_scripts/imagenet/run_in_stand_inf_50-2.sh), on the CUDA card.
# Usage: bash run_in_stand_inf_50-2.sh [seed_id] [data_id]
cd "$(dirname "$0")/../../.."

SEED=${1:-0}
DATA_SEED=${2:-0}

python -m diffpure_tpu_torch.cli \
  --exp ./exp_results \
  --seed $SEED \
  --data_seed $DATA_SEED \
  --config imagenet.yml \
  --domain imagenet \
  --diffusion_type sde \
  --score_type guided_diffusion \
  --adv_batch_size 4 \
  --num_sub 16 \
  --t 150 \
  --adv_eps 0.0157 \
  --classifier_name imagenet-wideresnet-50-2 \
  --attack_version standard
