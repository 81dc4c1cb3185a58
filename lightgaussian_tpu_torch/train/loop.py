"""The training loop shared by the training CLIs.

Port of `lightgaussian_tpu/train/loop.py`: around `train_step`, the
SH-degree schedule, shuffled camera sampling, densify, prune and opacity
reset on schedule, GSS pruning at given iterations with a decayed percent,
test-iteration reports, PLY saves, checkpoints, and the `imp_score.npz`
export. The work stays on the device; this module decides when to run what.

What differs from the JAX loop, on purpose: the instance buffer is sized per
frame from the live count (`binning.bin_splats`), so `max_instances` is only
a cut that costs nothing to hold high. The loop therefore grows it as soon
as a step reports a count near it, past the JAX package's 2^24 up to the
port's `binning.MAX_CAPACITY`, and never shrinks it; the JAX loop's shrink
policy saves a cost that does not exist here. The viewer's frames keep every
live instance.
"""
from __future__ import annotations

import dataclasses
import random as pyrandom
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from lightgaussian_tpu_torch.config import OptimizationParams, TrainConfig
from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.ops import losses
from lightgaussian_tpu_torch.ops.rasterize import default_max_instances, render
from lightgaussian_tpu_torch.ops.rasterize.binning import MAX_CAPACITY, snug_capacity
from lightgaussian_tpu_torch.train import checkpoint as ckpt_mod
from lightgaussian_tpu_torch.train import densify as densify_mod
from lightgaussian_tpu_torch.train import gss
from lightgaussian_tpu_torch.train.state import TrainState, grow_capacity, init_train_state
from lightgaussian_tpu_torch.train.step import make_eval_render, make_train_step
from lightgaussian_tpu_torch.utils.logging import MetricsLogger, StepTimer, training_report

# Pending step metrics are read from the device this many iterations at a
# time, in one transfer, so that no iteration waits on its own loss.
SYNC_LAG = 8
# The instance cut grows (to `snug_capacity` of the live count) when a
# frame's count comes within this share of it.
GROW_TRIGGER = 0.85


def grown_cut(cut: int, live: int) -> int:
    """The instance cut after a step of `live` instances: once they pass
    GROW_TRIGGER of it, `snug_capacity` of them, at most MAX_CAPACITY (a
    frame past that raises in binning; none is cut there)."""
    if live > GROW_TRIGGER * cut:
        return min(snug_capacity(live), MAX_CAPACITY)
    return cut


@dataclasses.dataclass
class LoopCallbacks:
    """Optional hooks (custom logging, profiling)."""

    on_iteration: Callable | None = None  # (iteration, state, metrics) -> None


def make_profiler_callback(trace_dir: str, start_iter: int = 100, n_steps: int = 5):
    """An on-iteration hook that records a `torch.profiler` trace (host and,
    on a card, device activity) of steps [start_iter, start_iter + n_steps)
    and writes it as `<trace_dir>/trace.json`, a Chrome trace."""
    box = {}

    def on_iteration(iteration, state, metrics):
        if iteration == start_iter:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if state.scene.means.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            print(f"[{iteration}] starting torch.profiler trace -> {trace_dir}")
            box["prof"] = torch.profiler.profile(activities=activities)
            box["prof"].start()
        elif iteration == start_iter + n_steps and "prof" in box:
            if state.scene.means.device.type == "cuda":
                torch.cuda.synchronize(state.scene.means.device)
            prof = box.pop("prof")
            prof.stop()
            Path(trace_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))
            print(f"[{iteration}] profiler trace written to {trace_dir}")

    return on_iteration


def save_imp_score(path: str | Path, scene, v_imp) -> None:
    """`imp_score.npz`: one score per ALIVE Gaussian, in PLY row order (key
    `arr_0`). The file must line up with the packed `point_cloud.ply` that
    the compression CLI reads back, not with this run's capacity layout."""
    v = v_imp.detach().cpu().numpy() if isinstance(v_imp, torch.Tensor) else np.asarray(v_imp)
    alive = scene.alive.cpu().numpy()
    if v.shape[0] == alive.shape[0]:
        v = v[alive]
    np.savez(Path(path), v)


PRUNE_TYPES = ("important_score", "v_important_score", "max_v_important_score", "count", "opacity")


def gss_prune(
    state: TrainState,
    cameras: Sequence[Camera],
    bg: torch.Tensor,
    percent: float,
    v_pow: float,
    max_instances: int,
    prune_type: str = "v_important_score",
) -> tuple[TrainState, torch.Tensor]:
    """One GSS pruning pass: sum the scores over ALL train cameras, rank by
    `prune_type`, drop the lowest `percent`. Returns the state and the
    volume-weighted score of every slot."""
    if prune_type not in PRUNE_TYPES:
        raise ValueError(f"unknown prune_type {prune_type!r}; one of {PRUNE_TYPES}")
    counts, imp = gss.accumulate_gss_auto(state.scene, cameras, bg, max_instances)
    v_imp = gss.calculate_v_imp_score(state.scene, imp, v_pow)
    if prune_type == "important_score":
        scores = imp
    elif prune_type == "v_important_score":
        scores = v_imp
    elif prune_type == "max_v_important_score":
        # importance times the largest scale, not the volume-normalised score
        scores = imp * state.scene.scales.amax(dim=1)
    elif prune_type == "count":
        scores = counts.to(torch.float32)
    else:
        scores = state.scene.opacities
    keep = gss.percentile_keep_mask(state.scene, scores, percent)
    return densify_mod.prune_by_mask(state, keep), v_imp


# The most the cached ground-truth SSIM moments may take when the cache is
# left to choose for itself: two float32 planes the size of the image per
# camera, twice the image itself.
_GT_SSIM_CACHE_BUDGET_BYTES = 4 << 30


def _attach_gt_ssim_stats(cams: list[Camera], enable: bool | None) -> list[Camera]:
    """Give every train camera its ground truth's SSIM moments, computed
    once. `enable=None` decides by the budget. The moments are what the
    step's own blur of the ground truth would give, so this changes the
    step's time, not its results."""
    sized = [c for c in cams if c.gt_image is not None]
    if not sized:
        return cams
    if len(sized) != len(cams):
        # the step takes one kind of camera: all with the moments, or none
        print(
            f"gt-SSIM moment cache disabled: {len(cams) - len(sized)} of "
            f"{len(cams)} train cameras carry no gt image"
        )
        return cams
    extra = sum(2 * 4 * c.gt_image.numel() for c in sized)
    if enable is None:
        enable = extra <= _GT_SSIM_CACHE_BUDGET_BYTES
        if not enable:
            print(
                f"gt-SSIM moment cache disabled: {extra / 1e9:.1f} GB for "
                f"{len(sized)} cameras exceeds the {_GT_SSIM_CACHE_BUDGET_BYTES / 1e9:.0f} GB "
                "auto budget (pass cache_gt_ssim=True to force)"
            )
    if not enable:
        return cams
    return [c.with_gt_ssim_stats(losses.precompute_ssim_target_stats(c.gt_image)) for c in cams]


def train(
    scene,
    cfg: TrainConfig,
    bg: torch.Tensor,
    state: TrainState | None = None,
    first_iter: int = 0,
    max_instances: int | None = None,
    densify: bool = True,
    lr_mult_fn=None,
    sh_degree_interval: int | None = 1000,
    callbacks: LoopCallbacks | None = None,
    logger: MetricsLogger | None = None,
    seed: int = 0,
    prune_type: str = "v_important_score",
    camera_batch: int = 1,
    cache_gt_ssim: bool | None = None,
    gui=None,
    gui_source_path: str = "",
) -> TrainState:
    """Run the training loop over `scene` (a `data.scene.Scene`); returns
    the final state.

    With `densify=True` this is the densify-and-prune trainer; with
    `densify=False` and `lr_mult_fn` it is the finetune loop.

    `camera_batch > 1`: each iteration draws that many cameras (a list,
    without replacement from the shuffled stack, in the JAX loop's order)
    and makes ONE Adam update on their mean loss; `opt.iterations` then
    counts optimizer steps, not cameras.

    `gui` (a `render.network_gui.NetworkGUI`) takes a waiting viewer
    before each iteration and, while one is connected, is polled with the
    step timer paused; its frames are renders of the current scene through
    the render-only kernel (B6), and `gui_source_path` is the verify string
    it sends back.
    """
    opt: OptimizationParams = cfg.opt
    cams = _attach_gt_ssim_stats(list(scene.getTrainCameras()), cache_gt_ssim)
    test_cams = list(scene.getTestCameras())
    if state is None:
        state = init_train_state(scene.gaussians)
    dev = state.scene.means.device
    if max_instances is None:
        max_instances = default_max_instances(state.scene)

    def make_fns():
        return (
            make_train_step(opt, scene.cameras_extent, max_instances, lr_mult_fn=lr_mult_fn,
                            update_densify_stats=densify, camera_batch=camera_batch),
            make_eval_render(max_instances),
        )

    step_fn, eval_fn = make_fns()
    logger = logger or MetricsLogger(scene.model_path)
    timer = StepTimer()
    rng = pyrandom.Random(seed)
    noise = torch.Generator(device=dev).manual_seed(seed)

    camera_stack: list[Camera] = []
    ema_loss = 0.0
    model_path = Path(scene.model_path)
    pending: list = []  # [(iteration, loss tensor), ...] oldest first

    def consume_metrics() -> None:
        """Read every pending loss, in one transfer (waits for the newest)."""
        nonlocal ema_loss
        ready, pending[:] = list(pending), []
        if not ready:
            return
        fetched = torch.stack([loss for _, loss in ready]).tolist()
        for (it0, _), loss in zip(ready, fetched):
            ema_loss = 0.4 * loss + 0.6 * ema_loss if it0 > first_iter + 1 else loss
            logger.scalar("train_loss_patches/total_loss", loss, it0)

    def pause_timer() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timer.pause()

    last_print_t = time.time()
    white_background = bool((bg == 1.0).all())

    def gui_render(cam, scale_mod):
        """The viewer's frame at its pose, resolution and scale, every live
        instance rendered."""
        with torch.no_grad():
            return render(state.scene, cam, bg, scale_modifier=scale_mod, fast=True).render

    def draw() -> Camera:
        nonlocal camera_stack
        if not camera_stack:
            camera_stack = list(cams)
        return camera_stack.pop(rng.randrange(len(camera_stack)))

    for iteration in range(first_iter + 1, opt.iterations + 1):
        if gui is not None:
            if gui.conn is None:
                gui.try_connect()
            if gui.conn is not None:  # no viewer, no sync: the host queues on
                pause_timer()
                gui.poll(gui_render, gui_source_path, iteration >= opt.iterations)

        timer.resume()

        if sh_degree_interval and iteration % sh_degree_interval == 0:
            state = dataclasses.replace(state, scene=state.scene.one_up_sh_degree())

        cam = [draw() for _ in range(camera_batch)] if camera_batch > 1 else draw()

        state, metrics = step_fn(state, cam, bg)
        pending.append((iteration, metrics.loss))
        if iteration % SYNC_LAG == 0:
            consume_metrics()

        # The step read the frame's live instance count; grow the cut before
        # (or, at the latest, right after) it truncates the deepest splats.
        inst_used = metrics.num_instances
        if inst_used > max_instances:
            print(
                f"[{iteration}] instance buffer overflow: {inst_used} >= "
                f"capacity {max_instances}: deepest splats truncated this step; growing"
            )
        new_cap = grown_cut(max_instances, inst_used)
        if new_cap != max_instances:
            print(
                f"[{iteration}] instance buffer {inst_used} vs capacity "
                f"{max_instances}; growing to {new_cap} (the ceiling is MAX_CAPACITY "
                f"{MAX_CAPACITY}, the int32 tile ranges')"
            )
            max_instances = new_cap
            step_fn, eval_fn = make_fns()

        if iteration % 100 == 0:
            consume_metrics()
            now = time.time()
            its = 100.0 / max(now - last_print_t, 1e-9)
            last_print_t = now
            print(
                f"[{iteration}/{opt.iterations}] loss={ema_loss:.5f} "
                f"alive={state.scene.num_alive()} {its:.1f} it/s"
            )

        # the densification window
        if densify and iteration < opt.densify_until_iter:
            if iteration > opt.densify_from_iter and iteration % opt.densification_interval == 0:
                size_thresh = 20 if iteration > opt.opacity_reset_interval else 0
                state, report = densify_mod.densify_and_prune(
                    state, opt.densify_grad_threshold, 0.005, scene.cameras_extent,
                    size_thresh, opt.percent_dense, noise,
                )
                print(
                    f"[{iteration}] densify: cloned {report.n_cloned}, split {report.n_split}, "
                    f"pruned {report.n_pruned}, dropped {report.n_dropped}, alive {report.n_alive}"
                )
                # Grow the Gaussian capacity before the free-slot clamp starts
                # dropping clones and splits.
                cap = state.scene.capacity
                if report.n_alive > 0.9 * cap:
                    new_cap = ((int(cap * 3 // 2) + 127) // 128) * 128
                    print(f"[{iteration}] gaussians near capacity {cap}; growing to {new_cap}")
                    state = grow_capacity(state, new_cap)
            if iteration % opt.opacity_reset_interval == 0 or (
                white_background and iteration == opt.densify_from_iter
            ):
                # on a white background the early reset culls background-coloured floaters
                state = densify_mod.reset_opacity(state)

        # the in-training GSS prune
        if iteration in cfg.prune_iterations:
            consume_metrics()
            i = cfg.prune_iterations.index(iteration)
            percent = cfg.prune_percent * (cfg.prune_decay**i)
            print(f"[{iteration}] GSS prune {percent:.2%} (pass {i})")
            before = state.scene.num_alive()
            state, _ = gss_prune(
                state, cams, bg, percent, cfg.v_pow, max_instances, prune_type=prune_type,
            )
            print(f"  {before} -> {state.scene.num_alive()} gaussians")

        if iteration in cfg.test_iterations:
            consume_metrics()
            pause_timer()
            # the eval render takes cameras without the cached moments
            training_report(
                logger, iteration, state.scene, eval_fn, test_cams,
                [c.with_gt_ssim_stats(None) for c in cams[:5]], bg, timer.total,
            )

        if iteration in cfg.save_iterations:
            pause_timer()
            print(f"[{iteration}] Saving point cloud")
            scene.save(iteration, state.scene)

        if iteration in cfg.checkpoint_iterations:
            pause_timer()
            print(f"[{iteration}] Saving checkpoint")
            ckpt_mod.save_checkpoint(
                model_path / f"chkpnt{iteration}.npz", state, iteration, scene.cameras_extent
            )
            if iteration == max(cfg.checkpoint_iterations):
                _, imp = gss.accumulate_gss_auto(state.scene, cams, bg, max_instances)
                v_imp = gss.calculate_v_imp_score(state.scene, imp, cfg.v_pow)
                save_imp_score(model_path / "imp_score.npz", state.scene, v_imp)

        if callbacks and callbacks.on_iteration:
            callbacks.on_iteration(iteration, state, metrics)

    consume_metrics()
    pause_timer()
    n_run = opt.iterations - first_iter
    if n_run > 0 and timer.total > 0:
        print(f"Training sections: {n_run} iterations in {timer.total:.2f} s ({n_run / timer.total:.2f} it/s)")
    return state
