"""PyTorch port: the measurement layer of `lightgaussian_tpu_torch/scripts/`
(the bench, the step, binning and backward profilers, and
`harness.trace_summary`) and the pieces of the path they time.

- The bench step at batch 1 and 2 against `jax.grad` of the same loss built
  from the JAX package's functions as the root `bench.py` builds it
  (`render` with `max_instances`, `gs_loss` with the cached target moments;
  the JAX render in interpret mode), on the same seeded arrays carried across
  by `convert.py`: every parameter's gradient within 5e-5 of the JAX
  field's largest magnitude (the blend's tolerance), the loss within rel
  1e-6.
- The bench's JSON line on the CPU: its six keys, and its value the pixels
  over the median step.
- `bin_splats`'s pieces composed in order give its outputs bit for bit on a
  random scene, on a scene whose rects take the >32-tile fallback, and on a
  scene cut at `max_instances`.
- The B2 seed helper gives what `_ExactBlend.backward` hands B2, and the
  autograd gradients are B2's on the seed written out.
- The preprocess backward cut at its SH colours and 3D covariances sums,
  per parameter, to the single autograd call within 1e-6 of its largest
  magnitude (the cut reassociates a few float32 sums).
- `trace_summary` on a hand-written Chrome trace (exact numbers), and on a
  real `torch.profiler` CPU trace (no device events: it must not fail).
- Each profiler runs whole on the CPU at a tiny size.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.models.camera import Camera as JCamera
from lightgaussian_tpu.ops import losses as jl
from lightgaussian_tpu.ops.rasterize import render as jrender
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch import convert
from lightgaussian_tpu_torch.ops.rasterize import binning as tb
from lightgaussian_tpu_torch.ops.rasterize import blend, render, tiled
from lightgaussian_tpu_torch.ops.rasterize.projection import Splats, preprocess
from lightgaussian_tpu_torch.ops import losses as tl
from lightgaussian_tpu_torch.scripts import (bench, harness, profile_binning, profile_binning_infer, profile_bwd,
                                             profile_step)
from lightgaussian_tpu_torch.train.step import param_leaves
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

W, H = 96, 64
N = 256
CAP = 1 << 14
CPU = torch.device("cpu")


def _np(x):
    return x.detach().cpu().numpy()


def _jax_cameras(batch):
    if batch == 1:
        return [jsyn.default_camera(width=W, height=H, dist=5.0)]
    return [JCamera.look_at(eye=[5.0 * np.sin(0.2 + 0.01 * i), 0.6, -5.0 * np.cos(0.2 + 0.01 * i)],
                            target=[0, 0, 0], width=W, height=H) for i in range(batch)]


@pytest.mark.parametrize("batch", [1, 2])
def test_bench_step_matches_jax_grad(batch):
    jscene = jsyn.random_scene(n=N, seed=1)
    arrays = {k: np.asarray(v) for k, v in jscene.params().items()}
    tscene = convert.scene_from_numpy(arrays, np.asarray(jscene.alive), jscene.active_sh_degree,
                                      jscene.max_sh_degree, device="cpu")
    jcams = _jax_cameras(batch)
    tcams = bench.bench_cameras(batch, W, H, CPU)
    for jc, tc in zip(jcams, tcams):
        np.testing.assert_array_equal(_np(tc.full_proj), np.asarray(jc.full_proj))
    jtarget = jnp.zeros((3, H, W), jnp.float32)
    jstats = jl.precompute_ssim_target_stats(jtarget)
    jbg = jnp.zeros((3,), jnp.float32)

    def loss_fn(params):
        s = jscene.with_params(params)
        per_view = [jl.gs_loss(jrender(s, c, jbg, max_instances=CAP, interpret=True).render, jtarget,
                               target_stats=jstats) for c in jcams]
        return jnp.stack(per_view).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jscene.params())
    target = torch.zeros((3, H, W))
    step = bench.make_step(tscene, tcams, torch.zeros(3), target, tl.precompute_ssim_target_stats(target), CAP)
    loss, grads, live = step()
    assert 0 < live <= CAP
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    for k, want in jgrads.items():
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0, k
        assert np.abs(_np(grads[k]) - want).max() <= 5e-5 * scale, k


def test_bench_prints_its_line(monkeypatch, tmp_path, capsys):
    for name, v in (("N_GAUSS", N), ("WIDTH", W), ("HEIGHT", H), ("MAX_INSTANCES", CAP)):
        monkeypatch.setattr(bench, name, v)
    assert bench.main(["--device", "cpu", "--iters", "1", "--repeats", "3", "--out_root", str(tmp_path)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert set(line) == {"metric", "value", "unit", "median_ms", "spread_ms", "groups"}
    assert line["metric"] == "pixels_per_sec_per_chip_fwd_bwd_1080p" and line["unit"] == "pixels/s"
    assert line["groups"] == 3 and line["spread_ms"][0] <= line["median_ms"] <= line["spread_ms"][1]
    assert line["value"] == round(W * H / (line["median_ms"] * 1e-3))
    assert out[-2] == harness.card_line(CPU)
    report = json.loads((tmp_path / "bench.json").read_text())
    assert report["value"] == line["value"] and len(report["group_ms"]) == 3


def _random_splats():
    scene = tsyn.random_scene(n=N, seed=1, device="cpu")
    with torch.no_grad():
        return preprocess(scene, tsyn.default_camera(width=W, height=H, device="cpu"))


def _fallback_splats():
    """Round Gaussians of radius 150 px over a 320x256 grid (80 tiles): rects
    of more than 32 tiles, which take the rect-slot fallback, beside small
    ones that take the exact mask."""
    rng = np.random.default_rng(3)
    n = 48
    big = np.arange(n) % 3 == 0
    kw = dict(
        mean2d=rng.uniform([0, 0], [320, 256], (n, 2)).astype(np.float32),
        conic=np.where(big[:, None], [[1 / 2500, 0.0, 1 / 2500]], [[0.05, 0.01, 0.08]]).astype(np.float32),
        color=rng.uniform(size=(n, 3)).astype(np.float32),
        opacity=rng.uniform(0.3, 0.9, n).astype(np.float32),
        depth=rng.uniform(1.0, 9.0, n).astype(np.float32),
        radius=np.where(big, 150, 12).astype(np.int32),
    )
    return Splats(**{k: torch.from_numpy(v) for k, v in kw.items()}), tb.make_grid(320, 256)


@pytest.mark.parametrize("case", ["random", "fallback", "cut"])
def test_binning_pieces_compose_to_bin_splats(case):
    if case == "fallback":
        splats, grid = _fallback_splats()
        cover = tb._cover(splats, grid)
        assert ((cover.mask == 0) & (cover.count > tb.MAX_MASK_TILES)).any()
        assert (cover.mask > 0).any()
    else:
        splats, grid = _random_splats(), tb.make_grid(W, H)
    cap = CAP
    if case == "cut":
        cap = tb.bin_splats(splats, grid, CAP).total // 2
    b = tb.bin_splats(splats, grid, cap)
    assert b.inst.shape[0] == min(b.total, tb.instance_capacity(cap)) > 0
    if case == "cut":
        assert b.inst.shape[0] < b.total
    calls, composed = profile_binning.compose(splats, grid, cap)
    assert [name for name, _ in calls] == list(profile_binning.PIECES)
    assert profile_binning.equals_bin_splats(composed, b)


def test_backward_seed_is_what_the_autograd_blend_hands_b2(monkeypatch):
    scene = tsyn.random_scene(n=N, seed=1, device="cpu")
    params = param_leaves(scene)
    splats = preprocess(scene.with_params(params), tsyn.default_camera(width=W, height=H, device="cpu"))
    bg = torch.tensor([0.1, 0.2, 0.3])
    grid = tb.make_grid(W, H)
    rng = np.random.default_rng(5)
    g_image = torch.from_numpy(rng.normal(size=(3, H, W)).astype(np.float32))
    g_t = torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32))
    handed = []
    real = blend.blend_backward

    def capture(ts, inst, gid, tile_g, tile_r, grid_, n):
        handed.append((tile_g, tile_r))
        return real(ts, inst, gid, tile_g, tile_r, grid_, n)

    monkeypatch.setattr(blend, "blend_backward", capture)
    image, final_t, _ = tiled.blend_tiled(splats, bg, W, H, CAP)
    got = torch.autograd.grad((image, final_t), (splats.mean2d, splats.conic, splats.color, splats.opacity),
                              (g_image, g_t))
    seed = tiled._backward_seed(image.detach(), final_t.detach(), g_image, g_t, grid)
    assert len(handed) == 1 and all(torch.equal(a, b) for a, b in zip(handed[0], seed))
    # the gradients are B2's on the seed written out
    b = tb.bin_splats(tiled._detached(splats), grid, CAP)
    r = (image.detach() * g_image).sum(dim=0) + final_t.detach() * g_t
    want = real(b.tile_starts, b.inst, b.gid_sorted, tiled._tile_image(g_image, grid),
                tiled._tile_image(r[None].contiguous(), grid), grid, N)
    assert float(want.abs().max()) > 0
    for g, cols in zip(got, (slice(0, 2), slice(2, 5), slice(5, 8), 8)):
        assert torch.equal(g, want[:, cols])


def test_preprocess_backward_split_sums_to_one_call():
    bw = profile_bwd.backward_inputs(CPU, W, H, 2000, CAP)
    one = profile_bwd.preprocess_grads(bw)
    calls, split = profile_bwd.split_backward(bw)
    assert list(calls) == list(profile_bwd.SPLIT)
    assert set(split) == set(one)
    for k, want in one.items():
        scale = float(want.abs().max())
        assert scale > 0, k
        assert float((split[k] - want).abs().max()) <= 1e-6 * scale, k


def _x(name, cat, ts, dur, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur}


B1_NAME = "void blend_tile_kernel<true, false>(int const*, int const*, float const*, float*, float*, int, int, int, int)"
B2_NAME = "void blend_backward_kernel(int const*, int const*, float const*, long const*, float const*, float*)"
B3_NAME = "void moment_rows_kernel<true, 3>(float const*, float const*, float*, int, int, int, int, int, Taps)"
B4_NAME = "void blur_rows_kernel<true>(float const*, float*, int, int, int, int, int, int, Taps)"
B7_MANGLED = "_Z18moment_rows_kernelILb0ELi5EEvPKfS1_Pfiiiii4Taps"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int, ...)"


def test_trace_summary_on_a_hand_written_trace(tmp_path):
    events = [
        # device: two streams (7, 8) that overlap, a memset and a memcpy
        _x(B1_NAME, "kernel", 100, 50),
        _x(B2_NAME, "kernel", 120, 60, tid=8),
        _x("Memset (Device)", "gpu_memset", 200, 10),
        _x(B3_NAME, "kernel", 300, 40),
        _x(B4_NAME, "kernel", 330, 30, tid=8),
        _x(ELEMENTWISE, "kernel", 400, 5),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 500, 20),
        _x(B1_NAME, "kernel", 600, 50),
        _x(B7_MANGLED, "kernel", 600, 10, tid=8),
        # host: the step, and spans running at the gaps' starts
        _x("ProfilerStep#1", "cpu_op", 0, 700, tid=1),
        _x("cudaLaunchKernel", "cuda_runtime", 175, 10, tid=1),
        _x("aten::sort", "cpu_op", 190, 110, tid=1),
        _x("aten::empty", "cpu_op", 205, 3, tid=1),
        _x("aten::mul", "cpu_op", 350, 15, tid=1),
        _x("aten::item", "cpu_op", 400, 120, tid=1),
        _x("cudaMemcpyAsync", "cuda_runtime", 404, 115, tid=1),
        # ignored: no duration, other categories
        {"ph": "i", "cat": "kernel", "name": B1_NAME, "ts": 50, "pid": 0, "tid": 7},
        _x("forward", "python_function", 0, 900, tid=1),
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 100, "id": 1, "pid": 0, "tid": 7},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = harness.trace_summary(path)
    assert got["window"] == 550.0
    assert got["busy"] == 80.0 + 10.0 + 60.0 + 5.0 + 20.0 + 50.0
    assert set(got) == {"window", "busy", "launches", "hand_written", "top_ops", "gaps"}
    assert got["launches"] == {B1_NAME: 2, B2_NAME: 1, B3_NAME: 1, B4_NAME: 1, ELEMENTWISE: 1, B7_MANGLED: 1}
    assert got["hand_written"] == {"blend_forward": 2, "blend_forward_fast": 0, "blend_count": 0, "blend_backward": 1,
                                   "blur": 1, "blur3": 1, "blur5": 1, "unchunk_transpose": 0, "issue_probe": 0,
                                   "bin_cover": 0, "bin_emit": 0, "preprocess_forward": 0,
                                   "preprocess_backward": 0}
    assert got["top_ops"] == [(B1_NAME, 100.0, 2), (B2_NAME, 60.0, 1), (B3_NAME, 40.0, 1), (B4_NAME, 30.0, 1),
                              ("Memcpy DtoH (Device -> Pageable)", 20.0, 1), ("Memset (Device)", 10.0, 1),
                              (B7_MANGLED, 10.0, 1), (ELEMENTWISE, 5.0, 1)]
    assert got["gaps"] == [(405.0, 95.0, "cudaMemcpyAsync"), (210.0, 90.0, "aten::sort"),
                           (520.0, 80.0, "ProfilerStep#1"), (360.0, 40.0, "aten::mul"),
                           (180.0, 20.0, "cudaLaunchKernel")]


def test_trace_summary_reads_a_cpu_profiler_trace(tmp_path, monkeypatch):
    for name, v in (("N_GAUSS", N), ("WIDTH", W), ("HEIGHT", H), ("MAX_INSTANCES", CAP)):
        monkeypatch.setattr(bench, name, v)
    counted = profile_step.trace_steps(CPU, 2, tmp_path / "trace.json")
    got = harness.trace_summary(tmp_path / "trace.json")
    assert got["window"] == 0.0 and got["busy"] == 0.0
    assert got["launches"] == {} and got["top_ops"] == [] and got["gaps"] == []
    assert set(got["hand_written"]) == set(counted) and not any(got["hand_written"].values())


def _tiny(monkeypatch):
    for mod in (profile_binning, profile_bwd):
        for name, v in (("N_GAUSS", 1000), ("WIDTH", W), ("HEIGHT", H), ("CAP", CAP), ("REPS", 1)):
            monkeypatch.setattr(mod, name, v)
    for name, v in (("N_GAUSS", 1000), ("WIDTH", W), ("HEIGHT", H), ("MAX_INSTANCES", CAP)):
        monkeypatch.setattr(bench, name, v)
    monkeypatch.setattr(profile_step, "REPS", 1)
    monkeypatch.setattr(profile_binning_infer, "POINTS", {"default": (800, 80, 48, 2), "large": (1000, W, H, 3)})
    monkeypatch.setattr(profile_binning_infer, "REPS", 1)


def test_binning_infer_frame_inputs_give_its_fresh_frame(monkeypatch):
    """`frame_inputs` is the operating point the profiler's fresh frame row
    renders (and the smoke's phase 10c times beside the serving frame)."""
    _tiny(monkeypatch)
    scene, cam, bg, live, cap = profile_binning_infer.frame_inputs("large", CPU)
    assert (scene.capacity, scene.active_sh_degree, cam.width, cam.height) == (1000, 3, W, H)
    assert live > 0 and cap == tb.snug_capacity(live)
    with torch.no_grad():
        assert render(scene, cam, bg, max_instances=cap, fast=True).num_instances == live


@pytest.mark.parametrize("name, argv, rows", [
    ("profile_step", ["--trace_steps", "2"], ["whole step (forward, loss, backward)", "idle share"]),
    ("profile_binning", [], list(profile_binning.PIECES) + ["bin_splats whole", "bit-equal"]),
    ("profile_binning_infer", ["--large"], ["fresh frame", "rebind_features", "bit-equal"]),
    ("profile_bwd", [], ["B2 seed", "preprocess backward (one autograd call)", "covariance backward"]),
])
def test_profiler_runs_whole_on_the_cpu(name, argv, rows, monkeypatch, tmp_path, capsys):
    _tiny(monkeypatch)
    mod = {"profile_step": profile_step, "profile_binning": profile_binning,
           "profile_binning_infer": profile_binning_infer, "profile_bwd": profile_bwd}[name]
    assert mod.main([*argv, "--device", "cpu", "--out_root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for row in rows:
        assert row in out, row
    reports = sorted(p.name for p in tmp_path.glob("*.json"))
    assert reports and all(json.loads((tmp_path / r).read_text()) for r in reports)
    if name == "profile_step":
        assert profile_step.main(["--trace", str(tmp_path / "profile_step_trace.json")]) == 0
        assert "device window 0.000 ms, busy 0.000 ms\n" in capsys.readouterr().out
