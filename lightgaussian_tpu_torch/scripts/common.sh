#!/bin/bash
# Shared helpers for the orchestration scripts (the port's counterpart of
# scripts/common.sh).
#
# The reference farms scenes across GPUs by polling nvidia-smi
# (its scripts/run_prune_finetune.sh). These scripts do not: jobs run one at
# a time per host unless MAX_JOBS says otherwise, and a job runs on the
# card CUDA_VISIBLE_DEVICES gives it. wait_for_slot caps local concurrency.

MAX_JOBS="${MAX_JOBS:-1}"

wait_for_slot() {
  while [ "$(jobs -rp | wc -l)" -ge "$MAX_JOBS" ]; do
    sleep 10
  done
}

launch() {
  # launch <logfile> <cmd...>
  local log="$1"; shift
  mkdir -p "$(dirname "$log")"
  echo "launch: $* (log: $log)"
  nohup "$@" > "$log" 2>&1 &
}
