"""PyTorch port vs the JAX package: evaluation (LPIPS, SSIM/PSNR metrics,
the `metrics` and `full_eval` CLIs).

Held on the CPU:
- `random_lpips_params(0)`: every convolution within 2 ulp of the JAX
  package's (both draw with `jax.random.normal`; the port through
  `utils/threefry.py`), the lin weights and biases equal;
- `lpips` with the JAX parameters carried across (`convert.
  lpips_params_from_numpy`) and with a saved npz through
  `load_lpips_params` in both packages: within 1e-5 at 64x64 and 96x64,
  one image and a batch of two;
- `evaluate_model_paths` (SSIM through the five-moment blur, PSNR, LPIPS)
  on the same PNG directories: `results.json` and `per_view.json` with the
  same keys, SSIM and LPIPS within 1e-5, PSNR within 1e-4 dB (each package
  takes a float32 mean of the squared error over 9,216 x 3 values in its
  own order: 2.3e-5 of the MSE is 1e-4 dB), `lpips_kind` vgg-random;
- the `metrics` CLI and `full_eval` end to end (train, render, metrics) on
  the tiny Blender scene of tests/test_torch_train_loop.py mounted as a
  Tanks&Temples root, with the JAX CLIs' flags.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lightgaussian_tpu.cli import full_eval as jfull
from lightgaussian_tpu.cli import metrics as jmetrics_cli
from lightgaussian_tpu.eval import lpips as jlpips
from lightgaussian_tpu.eval import metrics as jmetrics
from lightgaussian_tpu_torch import convert
from lightgaussian_tpu_torch.cli import full_eval as tfull
from lightgaussian_tpu_torch.cli import metrics as tmetrics_cli
from lightgaussian_tpu_torch.eval import lpips as tlpips
from lightgaussian_tpu_torch.eval import metrics as tmetrics
from test_torch_train_loop import _write_blender_dataset

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_weights_file(monkeypatch):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)


@pytest.fixture(scope="module")
def jax_random_params():
    return jlpips.random_lpips_params(0)


def _carried(jp):
    return convert.lpips_params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp.convs],
                                           [np.asarray(lin) for lin in jp.lins], jp.kind, device="cpu")


def test_random_params_match_jax(jax_random_params):
    jp = jax_random_params
    tp = tlpips.random_lpips_params(0, device="cpu")
    assert tp.kind == jp.kind == "vgg-random"
    for i, (w, b) in enumerate(jp.convs):
        want = np.transpose(np.asarray(w), (3, 2, 0, 1))  # HWIO -> OIHW
        got = getattr(tp, f"conv{i}_w").numpy()
        assert got.shape == want.shape
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= 2, (i, ulps.max())
        np.testing.assert_array_equal(getattr(tp, f"conv{i}_b").numpy(), np.asarray(b))
    for s, lin in enumerate(jp.lins):
        np.testing.assert_array_equal(getattr(tp, f"lin{s}").numpy(), np.asarray(lin))


def _pair(rng, h, w, n=None):
    shape = (3, h, w) if n is None else (n, 3, h, w)
    x = rng.random(shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("h,w,n", [(64, 64, None), (64, 96, None), (64, 96, 2)])
def test_lpips_random_params_match_jax(rng, jax_random_params, h, w, n):
    x, y = _pair(rng, h, w, n)
    want = float(jlpips.lpips(jax_random_params, jnp.asarray(x), jnp.asarray(y)))
    carried = float(_carried(jax_random_params)(torch.from_numpy(x), torch.from_numpy(y)))
    own = float(tlpips.get_lpips_params(device="cpu")(torch.from_numpy(x), torch.from_numpy(y)))
    assert carried == pytest.approx(want, abs=1e-5)
    assert own == pytest.approx(want, abs=1e-5)
    assert float(_carried(jax_random_params)(torch.from_numpy(x), torch.from_numpy(x))) == 0.0


def test_lpips_saved_weights_match_jax(rng, tmp_path, monkeypatch):
    # a weights file in the converted layout, written by the converter from OIHW state dicts
    vgg, lin = {}, {}
    c_in = 3
    conv_ids = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    i = 0
    for c_out, n_convs in tlpips.VGG_BLOCKS:
        for _ in range(n_convs):
            vgg[f"{conv_ids[i]}.weight"] = (rng.normal(size=(c_out, c_in, 3, 3)) / np.sqrt(9 * c_in)).astype(np.float32)
            vgg[f"{conv_ids[i]}.bias"] = rng.normal(0, 0.01, c_out).astype(np.float32)
            c_in, i = c_out, i + 1
    for s, (c, _) in enumerate(tlpips.VGG_BLOCKS):
        lin[f"lin{s}.model.1.weight"] = rng.random((1, c, 1, 1)).astype(np.float32) / c
    tlpips.convert_torch_lpips(vgg, lin, tmp_path / "t.npz")
    jlpips.convert_torch_lpips(vgg, lin, tmp_path / "j.npz")
    with np.load(tmp_path / "t.npz") as zt, np.load(tmp_path / "j.npz") as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            np.testing.assert_array_equal(zt[k], zj[k])
    tp = tlpips.load_lpips_params(tmp_path / "t.npz", device="cpu")
    jp = jlpips.load_lpips_params(tmp_path / "t.npz")
    assert tp.kind == jp.kind == "vgg-pretrained"
    for h, w in ((64, 64), (64, 96)):
        x, y = _pair(rng, h, w)
        want = float(jlpips.lpips(jp, jnp.asarray(x), jnp.asarray(y)))
        assert float(tp(torch.from_numpy(x), torch.from_numpy(y))) == pytest.approx(want, abs=1e-5)
    # $LPIPS_WEIGHTS names the file
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "t.npz"))
    assert tlpips.get_lpips_params(device="cpu").kind == "vgg-pretrained"


def _method_dirs(root, rng, n_views=3, h=48, w=64):
    for method, noise in (("ours_7", 0.05), ("ours_8", 0.15)):
        for sub in ("renders", "gt"):
            (root / "test" / method / sub).mkdir(parents=True)
        for v in range(n_views):
            gt = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            render = np.clip(gt + rng.normal(0, 255 * noise, gt.shape), 0, 255).astype(np.uint8)
            Image.fromarray(gt).save(root / "test" / method / "gt" / f"{v:05d}.png")
            Image.fromarray(render).save(root / "test" / method / "renders" / f"{v:05d}.png")
    (root / "test" / "not_a_method").mkdir()


def _assert_results_close(got, want, metric=None):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_results_close(got[k], want[k], k if k in ("SSIM", "PSNR", "LPIPS") else metric)
        elif isinstance(want[k], str):
            assert got[k] == want[k]
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-4 if "PSNR" in (k, metric) else 1e-5), (metric, k)


def test_metrics_match_jax(rng, tmp_path):
    _method_dirs(tmp_path / "t", rng)
    import shutil

    shutil.copytree(tmp_path / "t", tmp_path / "j")
    tres = tmetrics.evaluate_model_paths([tmp_path / "t"], device="cpu")
    jres = jmetrics.evaluate_model_paths([tmp_path / "j"])
    _assert_results_close(tres[str(tmp_path / "t")], jres[str(tmp_path / "j")])
    for f in ("results.json", "per_view.json"):
        _assert_results_close(json.loads((tmp_path / "t" / f).read_text()), json.loads((tmp_path / "j" / f).read_text()))
    res = json.loads((tmp_path / "t" / "results.json").read_text())
    assert res["ours_7"]["lpips_kind"] == "vgg-random" and res["ours_7"]["PSNR"] > res["ours_8"]["PSNR"]
    img = tmetrics.load_image(tmp_path / "t" / "test" / "ours_7" / "gt" / "00000.png", device="cpu")
    np.testing.assert_array_equal(img.numpy(), np.asarray(jmetrics.load_image(tmp_path / "t" / "test" / "ours_7"
                                                                                / "gt" / "00000.png")))


def test_metrics_cli_matches_jax(rng, tmp_path):
    for d in ("t", "j"):
        _method_dirs(tmp_path / d, np.random.default_rng(4))
    tmetrics_cli.main(["-m", str(tmp_path / "t"), "--device", "cpu"])
    jmetrics_cli.main(["-m", str(tmp_path / "j")])
    _assert_results_close(json.loads((tmp_path / "t" / "results.json").read_text()),
                          json.loads((tmp_path / "j" / "results.json").read_text()))
    with pytest.raises(RuntimeError, match="CUDA"):
        tmetrics_cli.main(["-m", str(tmp_path / "t")])
    for jmod, tmod in ((jmetrics_cli, tmetrics_cli), (jfull, tfull)):
        jflags = {a.dest: a.default for a in jmod.build_parser()._actions if a.dest != "help"}
        tflags = {a.dest: a.default for a in tmod.build_parser()._actions if a.dest != "help"}
        assert tflags == {**{k: v for k, v in jflags.items() if k != "interpret"}, "device": "cuda"}


def test_full_eval_end_to_end(tmp_path, monkeypatch):
    root = tmp_path / "tat"
    _write_blender_dataset(root / "truck")
    monkeypatch.setattr(tfull, "TANKS_AND_TEMPLES", ["truck"])
    out = tmp_path / "eval_out"
    tfull.main(["-tat", str(root), "--output_path", str(out), "--iterations", "25", "--device", "cpu"])
    model = out / "truck"
    results = json.loads((model / "results.json").read_text())
    assert list(results) == ["ours_25"]
    assert results["ours_25"]["PSNR"] > 8 and results["ours_25"]["lpips_kind"] == "vgg-random"
    assert len(list((model / "test" / "ours_25" / "renders").glob("*.png"))) == 2
    assert len(json.loads((model / "per_view.json").read_text())["ours_25"]["PSNR"]) == 2
    # metrics only, over the model directories already there: the JAX package's metrics on the same renders
    (model / "results.json").unlink()
    tfull.main(["--skip_training", "--skip_rendering", "--output_path", str(out), "--device", "cpu"])
    got = json.loads((model / "results.json").read_text())
    jmetrics.evaluate_model_paths([model])
    _assert_results_close(got, json.loads((model / "results.json").read_text()))
