"""Readings that the limits of a cell's check are set from, on the card.

    python3 -m perfbench.calibrate --workload <name> --seeds 1 2 ... --control 3 [--seconds 2]

For each seed: the cell's set-up, a short window at the cell's own load, and
its check; the numbers compared are written as a line of JSON to
`build/calibrate/<name>.jsonl` in the checkout and printed. For the first `--control`
seeds also the control, the reference computed with its stage results held
in bfloat16 (`reference.render.bf16_round`) in the program's place, and, for a
training cell, the faults planted in the reference in the program's place:
the loss over half the image's rows, and a tile of the image altered where
it is rendered (`reference.train.ALTERED`). A state left unchanged needs no run: its change reads 1.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from perfbench import core
from perfbench.reference import render as R


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    core.env_for_caches()
    cell = core.Cell(args.workload)
    device = core.require_cuda(cell.entry["chips"])
    out = core.ROOT / "build" / "calibrate"
    out.mkdir(parents=True, exist_ok=True)
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        traffic = cell.traffic().Traffic(cell.config, cell.spec, seed, device)
        setup_s = time.perf_counter() - t0
        times, wall = core.window(traffic, args.seconds, device)
        traffic.close()
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        row = {"seed": seed, "setup_s": setup_s, "units": len(times), "wall_s": wall,
               "program": {k: v for k, (v, _) in traffic.check().items()}}
        row["check_s"] = time.perf_counter() - t1
        if n < args.control:
            if traffic.unit == "step":
                ref = traffic.summary(traffic.reference())
                row["control"] = traffic.gaps(traffic.summary(traffic.reference(q=R.bf16_round)), ref)
                for fault in ("half", "alter"):
                    row[f"fault_{fault}"] = traffic.gaps(traffic.summary(traffic.reference(fault=fault)), ref)
            else:
                ref = traffic.reference()
                ctl = traffic.reference(q=R.bf16_round)
                row["control"] = {"image_gap": max(float((a - b).abs().max()) for a, b in zip(ctl, ref))}
        line = json.dumps(row)
        print(line, flush=True)
        with open(out / f"{args.workload}.jsonl", "a") as f:
            f.write(line + "\n")
        del traffic
        gc.collect()
        torch.cuda.empty_cache()
    print(f"peak {torch.cuda.max_memory_allocated(device)} bytes; {core.power_limit()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
