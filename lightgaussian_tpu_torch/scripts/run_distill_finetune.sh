#!/bin/bash
# SH distillation deg 3 -> 2 with augmented views.
# PyTorch/CUDA build of the reference's scripts/run_distill_finetune.sh.
source "$(dirname "$0")/common.sh"

DATA_ROOT="${DATA_ROOT:-./data}"
OUT_ROOT="${OUT_ROOT:-./output}"
NEW_SH="${NEW_SH:-2}"
scenes=("${@:-bicycle}")

for scene in "${scenes[@]}"; do
  wait_for_slot
  launch "$OUT_ROOT/${scene}_distilled/distill.log" \
    python -m lightgaussian_tpu_torch.cli.distill_train \
      -s "$DATA_ROOT/$scene" -m "$OUT_ROOT/${scene}_distilled" --eval \
      --start_checkpoint "$OUT_ROOT/${scene}_pruned/chkpnt35000.npz" \
      --new_max_sh "$NEW_SH" --augmented_view --enable_covariance \
      --iteration_base 30000 --iterations_total 40000 \
      --test_iterations 35000 40000 --save_iterations 40000 \
      --checkpoint_iterations 40000
done
wait
