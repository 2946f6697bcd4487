#!/usr/bin/env bash
# PyTorch port of run_scripts/celebahq/run_celebahq_bpda_glasses.sh (same flags;
# ref run_scripts/celebahq/run_celebahq_bpda_glasses.sh), on the CUDA card.
# Usage: bash run_celebahq_bpda_glasses.sh [seed_id] [data_id]
cd "$(dirname "$0")/../../.."

SEED=${1:-0}
DATA_SEED=${2:-0}

python -m diffpure_tpu_torch.cli \
  --exp ./exp_results \
  --seed $SEED \
  --data_seed $DATA_SEED \
  --config celeba.yml \
  --domain celebahq \
  --diffusion_type celebahq-ddpm \
  --adv_batch_size 2 \
  --t 500 \
  --adv_eps 0.062745098 \
  --attack_version bpda \
  --classifier_name celebahq__Eyeglasses \
  --eot_defense_reps 20 \
  --eot_attack_reps 15
