#!/bin/bash
# Full 3D-GS training + densification + in-training GSS pruning, per scene.
# PyTorch/CUDA build of the reference's scripts/run_train_densify_prune.sh.
source "$(dirname "$0")/common.sh"

DATA_ROOT="${DATA_ROOT:-./data}"
OUT_ROOT="${OUT_ROOT:-./output}"
scenes=("${@:-bicycle}")

for scene in "${scenes[@]}"; do
  wait_for_slot
  launch "$OUT_ROOT/$scene/train.log" \
    python -m lightgaussian_tpu_torch.cli.train_densify_prune \
      -s "$DATA_ROOT/$scene" -m "$OUT_ROOT/$scene" --eval --disable_viewer \
      --prune_percent 0.6 --prune_decay 0.6 --prune_iterations 16000 24000 \
      --test_iterations 7000 30000 --save_iterations 30000 \
      --checkpoint_iterations 30000
done
wait
