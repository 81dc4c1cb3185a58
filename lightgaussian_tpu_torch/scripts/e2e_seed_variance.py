"""Seed variance of the HARD benchmark's GSS-vs-opacity margins on the port.

Port of `scripts/e2e_seed_variance.py`. Re-runs the short-finetune pair
([2s] GSS, [2t] opacity) and the [1b] no-prune control at extra seeds from
the checkpoint that `e2e_hard` trained (the seed changes the finetune's
camera shuffle, as re-seeding the reference's `prune_finetune.py` would),
scores each on the fixed test views, and appends a footnote to the
`e2e_hard` report under the same output root. Seed 0 is `e2e_hard`'s own
run, reused where its models are still on disk.

Usage: python -m lightgaussian_tpu_torch.scripts.e2e_seed_variance [--seeds 1 2]
           [--preset hard|hard1080] [--skip-control] [--device cuda] [--out_root DIR]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from lightgaussian_tpu_torch.cli import prune_finetune
from lightgaussian_tpu_torch.data import ply as ply_mod
from lightgaussian_tpu_torch.scripts import e2e_hard as eh
from lightgaussian_tpu_torch.scripts import harness
from lightgaussian_tpu_torch.utils.device import resolve_device


def run(preset: eh.Preset, out_root: Path, device: str | torch.device = "cuda", seeds=(1, 2),
        skip_control: bool = False) -> list[tuple]:
    """Returns [(seed, PSNR [2s], PSNR [2t], PSNR [1b] or nan)] and appends
    the footnote to the `e2e_hard` report."""
    dev = resolve_device(device)
    ws = eh.Workspace(Path(out_root), preset)
    it_train = preset.train_iters
    fts_end, ft_end = it_train + preset.ft_short, it_train + preset.ft_iters
    ckpt = ws.model / f"chkpnt{it_train}.npz"
    if not ckpt.exists():
        raise FileNotFoundError(f"{ckpt} missing: run `python -m lightgaussian_tpu_torch.scripts.e2e_hard "
                                f"--preset {preset.name}` with this output root first")
    test_cams, gts = eh.load_test_gt(preset, ws, dev)

    def run_ft(model_dir: Path, ptype: str | None, end: int, seed: int) -> float:
        """prune_finetune from the shared checkpoint; ptype None never prunes."""
        ply = model_dir / f"point_cloud/iteration_{end}/point_cloud.ply"
        if not ply.exists():
            argv = [
                "-s", str(ws.scene), "-m", str(model_dir),
                "--start_checkpoint", str(ckpt),
                "--iterations", str(end),
                "--eval", "--test_iterations", str(end),
                "--save_iterations", str(end),
                "--position_lr_max_steps", str(end),
                "--seed", str(seed), "--device", str(dev), "--quiet",
            ]
            if ptype is None:
                argv += ["--prune_iterations", str(10 * end)]
            else:
                argv += ["--prune_iterations", str(it_train + 5), "--prune_percent", str(eh.PRUNE_RATIO),
                         "--prune_type", ptype]
            prune_finetune.main(argv)
        scene = ply_mod.load_gaussian_ply(ply, device=dev)
        return eh.eval_scene(scene, test_cams, gts, preset, model_dir.name)["PSNR"]

    rows = []
    seed_dirs = {0: ("_pf_s", "_pf_op_s", "_ctrl")}
    for s in seeds:
        seed_dirs[s] = (f"_pf_s_seed{s}", f"_pf_op_s_seed{s}", f"_ctrl_seed{s}")
    t0 = time.time()
    for seed, (d2s, d2t, d1b) in sorted(seed_dirs.items()):
        p2s = run_ft(ws.variant(d2s), "v_important_score", fts_end, seed)
        p2t = run_ft(ws.variant(d2t), "opacity", fts_end, seed)
        p1b = float("nan") if skip_control else run_ft(ws.variant(d1b), None, ft_end, seed)
        rows.append((seed, p2s, p2t, p1b))
        print(f"seed {seed}: [2s] GSS+shortFT {p2s:.2f}  [2t] opacity+shortFT {p2t:.2f}  "
              f"(margin {p2s - p2t:+.2f} dB)  [1b] no-prune ctrl {p1b:.2f}", flush=True)

    margins = [r[1] - r[2] for r in rows]
    p2s_all, p2t_all, p1b_all = ([r[i] for r in rows] for i in (1, 2, 3))

    def stat(xs):
        return f"{np.mean(xs):.2f} (range {min(xs):.2f}..{max(xs):.2f})"

    what = ("The [2s]/[2t] short-finetune pair re-run" if skip_control else
            "The [2s]/[2t] short-finetune pair and the [1b] control re-run")
    lines = [
        "",
        f"## Seed-variance footnote (preset {preset.name})",
        "",
        f"{what} at {len(rows)} seeds (same chkpnt{it_train}; the seed varies the finetune camera shuffle; "
        f"`python -m lightgaussian_tpu_torch.scripts.e2e_seed_variance`, {(time.time() - t0) / 60:.0f} min):",
        "",
        "| seed | [2s] GSS+shortFT | [2t] opacity+shortFT | GSS margin |" + ("" if skip_control else " [1b] ctrl |"),
        "|---|---|---|---|" + ("" if skip_control else "---|"),
    ]
    for seed, p2s, p2t, p1b in rows:
        lines.append(f"| {seed} | {p2s:.2f} | {p2t:.2f} | {p2s - p2t:+.2f} dB |"
                     + ("" if skip_control else f" {p1b:.2f} |"))
    lines += [
        "",
        f"- [2s] PSNR {stat(p2s_all)}; [2t] {stat(p2t_all)}" + ("." if skip_control else f"; [1b] {stat(p1b_all)}."),
        f"- GSS-vs-opacity margin: **{np.mean(margins):+.2f} dB mean** "
        f"(range {min(margins):+.2f}..{max(margins):+.2f}): "
        + ("every seed positive; the margin clears the seed-to-seed spread."
           if min(margins) > 0 and np.mean(margins) > (max(margins) - min(margins)) / 2
           else "see the per-seed rows; read it against the spread."),
        f"- Seed-to-seed spread of one finetune configuration (max-min): [2s] {max(p2s_all) - min(p2s_all):.2f} dB, "
        f"[2t] {max(p2t_all) - min(p2t_all):.2f} dB"
        + ("" if skip_control else f", [1b] {max(p1b_all) - min(p1b_all):.2f} dB")
        + ": the yardstick for calling a full-budget gap re-convergence noise.",
    ]
    with ws.report.open("a") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    print(f"appended the seed-variance footnote to {ws.report}", flush=True)
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="seed variance of the HARD benchmark's GSS margins")
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    p.add_argument("--preset", choices=["hard", "hard1080"], default="hard")
    p.add_argument("--skip-control", action="store_true",
                   help="skip the [1b] full-budget no-prune control (the expensive row)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out_root", type=Path, default=None,
                   help="the output root e2e_hard ran with (default: the temporary directory)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run(eh.PRESETS[args.preset], args.out_root or harness.default_out_root(), args.device, args.seeds,
        args.skip_control)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
