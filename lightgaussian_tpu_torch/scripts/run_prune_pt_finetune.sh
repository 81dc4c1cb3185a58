#!/bin/bash
# Prune + short finetune starting from an interchange PLY instead of a
# training checkpoint. PyTorch/CUDA build of the reference's
# scripts/run_prune_pt_finetune.sh (5k iters, prune at iter 2).
source "$(dirname "$0")/common.sh"

DATA_ROOT="${DATA_ROOT:-./data}"
OUT_ROOT="${OUT_ROOT:-./output}"
PLY_ITER="${PLY_ITER:-30000}"
scenes=("${@:-bicycle}")

for scene in "${scenes[@]}"; do
  wait_for_slot
  launch "$OUT_ROOT/${scene}_pt_pruned/finetune.log" \
    python -m lightgaussian_tpu_torch.cli.prune_finetune \
      -s "$DATA_ROOT/$scene" -m "$OUT_ROOT/${scene}_pt_pruned" --eval \
      --start_pointcloud "$OUT_ROOT/$scene/point_cloud/iteration_$PLY_ITER/point_cloud.ply" \
      --iteration_base 0 --iterations 5000 --prune_iterations 2 \
      --prune_percent 0.66 --prune_type v_important_score \
      --test_iterations 5000 --save_iterations 5000 --checkpoint_iterations 5000
done
wait
