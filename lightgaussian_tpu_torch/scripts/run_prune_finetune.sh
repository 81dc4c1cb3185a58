#!/bin/bash
# One-shot 0.66 GSS prune of a trained checkpoint + recovery finetune.
# PyTorch/CUDA build of the reference's scripts/run_prune_finetune.sh (same
# operating point: prune_percent 0.66, decay 1, v_pow 0.1, v_important_score).
source "$(dirname "$0")/common.sh"

DATA_ROOT="${DATA_ROOT:-./data}"
OUT_ROOT="${OUT_ROOT:-./output}"
PRUNE_PERCENT="${PRUNE_PERCENT:-0.66}"
PRUNE_DECAY="${PRUNE_DECAY:-1}"
V_POW="${V_POW:-0.1}"
PRUNE_TYPE="${PRUNE_TYPE:-v_important_score}"
scenes=("${@:-bicycle}")

for scene in "${scenes[@]}"; do
  wait_for_slot
  launch "$OUT_ROOT/${scene}_pruned/finetune.log" \
    python -m lightgaussian_tpu_torch.cli.prune_finetune \
      -s "$DATA_ROOT/$scene" -m "$OUT_ROOT/${scene}_pruned" --eval \
      --start_checkpoint "$OUT_ROOT/$scene/chkpnt30000.npz" \
      --iterations 35000 --prune_iterations 30001 \
      --prune_percent "$PRUNE_PERCENT" --prune_decay "$PRUNE_DECAY" \
      --v_pow "$V_POW" --prune_type "$PRUNE_TYPE" \
      --test_iterations 30001 35000 --save_iterations 35000 \
      --checkpoint_iterations 35000
done
wait
