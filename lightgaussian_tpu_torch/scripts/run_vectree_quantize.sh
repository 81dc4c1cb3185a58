#!/bin/bash
# VecTree quantization of distilled checkpoints.
# PyTorch/CUDA build of the reference's scripts/run_vectree_quantize.sh (same
# operating point: vq_ratio 0.6, codebook 8192).
source "$(dirname "$0")/common.sh"

OUT_ROOT="${OUT_ROOT:-./output}"
VQ_RATIO="${VQ_RATIO:-0.6}"
CODEBOOK="${CODEBOOK:-8192}"
ITER="${ITER:-40000}"
scenes=("${@:-bicycle}")

for scene in "${scenes[@]}"; do
  wait_for_slot
  launch "$OUT_ROOT/${scene}_vq/vectree.log" \
    python -m lightgaussian_tpu_torch.cli.vectree \
      --important_score_npz_path "$OUT_ROOT/${scene}_distilled" \
      --input_path "$OUT_ROOT/${scene}_distilled/point_cloud/iteration_$ITER/point_cloud.ply" \
      --save_path "$OUT_ROOT/${scene}_vq" \
      --vq_ratio "$VQ_RATIO" --codebook_size "$CODEBOOK"
done
wait
