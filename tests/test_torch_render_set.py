"""PyTorch port vs the JAX package: files, dataset, scene, and the render CLI.

The serving path end to end on the CPU: a tiny Blender-format scene and a
saved model go through `lightgaussian_tpu.cli.render_sets` (Pallas in
interpret mode) and `lightgaussian_tpu_torch.cli.render_sets --device cpu`;
the PNGs must agree within one 8-bit level (1/255: the images agree to
2e-3, the fast blend's tolerance, and rounding to 8 bits can put such a
difference on either side of a level). Files (PLY, PNG) must round-trip bit
for bit between the packages, and the port must keep to the device it was
given: it raises where CUDA is asked for and absent, and never touches CUDA
when told to use the CPU.
"""
import json
import math
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from lightgaussian_tpu.data import dataset as jds
from lightgaussian_tpu.data import ply as jply
from lightgaussian_tpu.data import scene as jscene
from lightgaussian_tpu.models.camera import Camera as JCamera
from lightgaussian_tpu.render.poses import c2w_from_camera
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch.cli import render_sets as tcli
from lightgaussian_tpu_torch.data import dataset as tds
from lightgaussian_tpu_torch.data import ply as tply
from lightgaussian_tpu_torch.data import scene as tscene
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.utils import device as tdevice
from lightgaussian_tpu_torch.utils import image_io
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SIZE = 64
ITER = 7
FIELDS = GaussianScene.PARAM_FIELDS + ("alive",)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _write_dataset(root: Path) -> None:
    """Blender-format scene: PIL-written RGB and RGBA ground truths."""
    rng = np.random.default_rng(0)
    for split, n, phase in (("train", 2, 0.0), ("test", 2, 0.4)):
        frames = []
        for i in range(n):
            t = 2 * math.pi * i / n + phase
            cam = JCamera.look_at((2.5 * math.cos(t), 0.5, 2.5 * math.sin(t)), (0, 0, 0),
                                  fovx=0.9, width=SIZE, height=SIZE)
            (root / split).mkdir(parents=True, exist_ok=True)
            mode, ch = ("RGBA", 4) if i == 1 else ("RGB", 3)
            arr = rng.integers(0, 256, (SIZE, SIZE, ch), dtype=np.uint8)
            Image.fromarray(arr, mode).save(root / split / f"r_{i}.png")
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w_from_camera(cam, blender=True).tolist()})
        (root / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": 0.9, "frames": frames}))
    jply.store_point_cloud(root / "points3d.ply", rng.normal(0, 0.5, (50, 3)), rng.random((50, 3)) * 255)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_render")
    src = base / "scene"
    _write_dataset(src)
    model = base / "model"
    jscene_ = jsyn.random_scene(n=300, seed=5, extent=0.8, scale_range=(0.03, 0.1))
    jply.save_gaussian_ply(jscene_, model / "point_cloud" / f"iteration_{ITER}" / "point_cloud.ply")
    return src, model, jscene_


# ---- PLY -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(n=120, seed=0), dict(n=50, seed=1, max_sh_degree=0, capacity=64)])
def test_ply_port_to_jax(tmp_path, kw):
    t = tsyn.random_scene(device="cpu", **kw)
    alive = t.alive.clone()
    alive[::7] = False  # dead slots are not written
    t = GaussianScene(**{**{k: getattr(t, k) for k in t.PARAM_FIELDS}, "alive": alive,
                         "active_sh_degree": t.active_sh_degree, "max_sh_degree": t.max_sh_degree})
    path = tmp_path / "p.ply"
    tply.save_gaussian_ply(t, path)
    j = jply.load_gaussian_ply(path)
    n = int(alive.sum())
    keep = alive.numpy()
    for f in t.PARAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j, f))[:n], _np(getattr(t, f))[keep], err_msg=f)
    assert j.max_sh_degree == t.max_sh_degree
    # and the port reads its own file back into the same slots as JAX
    back = tply.load_gaussian_ply(path, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(back, f)), np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("new_sh", [None, 1, 0])
def test_ply_jax_to_port(tmp_path, new_sh):
    j = jsyn.random_scene(n=90, seed=2, capacity=100)
    path = tmp_path / "j.ply"
    jply.save_gaussian_ply(j, path)
    assert path.read_bytes()  # written by JAX
    want = jply.load_gaussian_ply(path, new_sh_degree=new_sh)
    got = tply.load_gaussian_ply(path, new_sh_degree=new_sh, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    assert (got.active_sh_degree, got.max_sh_degree) == (want.active_sh_degree, want.max_sh_degree)
    # byte-identical files when the port writes the same scene
    tply.save_gaussian_ply(got, tmp_path / "t.ply")
    jply.save_gaussian_ply(want, tmp_path / "j2.ply")
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j2.ply").read_bytes()
    with pytest.raises(ValueError, match="greater"):
        tply.load_gaussian_ply(path, new_sh_degree=4, device="cpu")


def test_ply_point_cloud_and_ascii(tmp_path):
    rng = np.random.default_rng(3)
    xyz, rgb = rng.normal(size=(20, 3)), rng.random((20, 3)) * 255
    tply.store_point_cloud(tmp_path / "a.ply", xyz, rgb)
    jply.store_point_cloud(tmp_path / "b.ply", xyz, rgb)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    for a, b in zip(tply.fetch_point_cloud(tmp_path / "a.ply"), jply.fetch_point_cloud(tmp_path / "a.ply")):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "c.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\nproperty uchar red\nend_header\n1.5 3\n-2 255\n"
    )
    got, want = tply.read_ply(tmp_path / "c.ply")["vertex"], jply.read_ply(tmp_path / "c.ply")["vertex"]
    np.testing.assert_array_equal(got.data, want.data)
    assert tply.gaussian_ply_fields(15) == jply.gaussian_ply_fields(15)


# ---- PNG -----------------------------------------------------------------

def _encode_with_filter(arr: np.ndarray, ftype: int) -> bytes:
    """A PNG whose every row uses PNG filter `ftype` (the forward filters)."""
    h, w, c = arr.shape
    rows = arr.reshape(h, w * c).astype(np.int64)
    out = []
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ftype == 0:
            f = cur
        elif ftype == 1:
            f = cur - left
        elif ftype == 2:
            f = cur - prev
        elif ftype == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            f = cur - pred
        out.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())
        prev = cur
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = image_io.struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (image_io._SIGNATURE + image_io._chunk(b"IHDR", ihdr)
            + image_io._chunk(b"IDAT", zlib.compress(b"".join(out))) + image_io._chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decoder_matches_pil_for_every_filter(tmp_path, channels):
    arr = np.random.default_rng(channels).integers(0, 256, (9, 13, channels), dtype=np.uint8)
    for ftype in range(5):
        path = tmp_path / f"f{ftype}.png"
        path.write_bytes(_encode_with_filter(arr, ftype))
        with Image.open(path) as img:
            want = np.asarray(img)
        want = want[:, :, None] if want.ndim == 2 else want
        np.testing.assert_array_equal(want, arr)  # the test's encoder is right
        np.testing.assert_array_equal(image_io.read_image(path), arr, err_msg=f"filter {ftype}")
        assert image_io.image_size(path) == (13, 9)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_read_by_pil(tmp_path, channels):
    arr = np.random.default_rng(10 + channels).integers(0, 256, (17, 11, channels), dtype=np.uint8)
    image_io.write_png(tmp_path / "w.png", arr)
    with Image.open(tmp_path / "w.png") as img:
        got = np.asarray(img)
    np.testing.assert_array_equal(got[:, :, None] if got.ndim == 2 else got, arr)
    # PIL-written files (its own filter choice) decode the same way
    Image.fromarray(arr[:, :, 0] if channels == 1 else arr).save(tmp_path / "p.png")
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "p.png"), arr)
    with pytest.raises(ValueError):
        image_io.write_png(tmp_path / "x.png", arr.astype(np.float32))


def test_non_png_goes_through_pil(tmp_path):
    arr = np.random.default_rng(4).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.bmp")
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "a.bmp"), arr)
    assert image_io.image_size(tmp_path / "a.bmp") == (8, 8)
    small = image_io.resize(arr, 4, 4)
    np.testing.assert_array_equal(small, np.asarray(Image.fromarray(arr).resize((4, 4))))


# ---- dataset and scene ------------------------------------------------------

@pytest.mark.parametrize("args", [(800, 800, -1, 1.0), (1920, 1080, -1, 1.0), (1920, 1080, 1, 1.0),
                                  (1920, 1080, 2, 1.0), (1000, 700, 500, 2.0), (640, 480, 4, 0.5)])
def test_target_resolution_matches_jax(args):
    assert tds._target_resolution(*args) == jds._target_resolution(*args)


def test_blender_reader_and_cameras_match_jax(workspace):
    src, _, _ = workspace
    for white in (False, True):
        j = jds.read_blender_scene(src, white_background=white, eval_split=True)
        t = tds.read_blender_scene(src, white_background=white, eval_split=True)
        assert len(t.train_cameras) == len(j.train_cameras) == 2 and len(t.test_cameras) == 2
        np.testing.assert_array_equal(t.nerf_normalization["translate"], j.nerf_normalization["translate"])
        assert t.nerf_normalization["radius"] == j.nerf_normalization["radius"]
        for ci_t, ci_j in zip(t.train_cameras + t.test_cameras, j.train_cameras + j.test_cameras):
            np.testing.assert_array_equal(ci_t.R, ci_j.R)
            np.testing.assert_array_equal(ci_t.T, ci_j.T)
            assert (ci_t.fovx, ci_t.fovy, ci_t.width, ci_t.height) == (ci_j.fovx, ci_j.fovy, ci_j.width, ci_j.height)
            assert tds.camera_to_json(3, ci_t) == jds.camera_to_json(3, ci_j)
            cam_t, cam_j = tds.load_camera(ci_t, device="cpu"), jds.load_camera(ci_j)
            for f in ("world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy", "gt_image"):
                np.testing.assert_array_equal(_np(getattr(cam_t, f)), np.asarray(getattr(cam_j, f)), err_msg=f)
    merged = tds.read_blender_scene(src)
    assert len(merged.train_cameras) == 4 and merged.test_cameras == []


def test_scene_matches_jax(workspace):
    src, model, _ = workspace
    kw = dict(eval_split=True, load_iteration=-1, shuffle=False)
    j = jscene.Scene(str(src), str(model), **kw)
    t = tscene.Scene(str(src), str(model), device="cpu", **kw)
    assert t.loaded_iter == j.loaded_iter == ITER
    assert t.cameras_extent == j.cameras_extent
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(t.gaussians, f)), np.asarray(getattr(j.gaussians, f)), err_msg=f)
    assert [c.width for c in t.getTestCameras()] == [c.width for c in j.getTestCameras()]
    assert tscene.max_saved_iteration(model / "point_cloud") == ITER
    shuffled = tscene.Scene(str(src), str(model), eval_split=True, load_iteration=ITER, device="cpu", seed=3)
    assert len(shuffled.getTrainCameras()) == 2


def test_unported_inputs_raise(workspace, tmp_path):
    """The inputs slice 1 left out are read now, as the JAX package reads
    them: a COLMAP source, a fresh run from the point cloud, and a saved
    iteration's `extreme_saving/` bundle (`load_vq`), in `Scene` and in the
    render CLI."""
    import shutil

    from lightgaussian_tpu.cli import render_sets as jcli
    from lightgaussian_tpu.compress import vectree as jvt
    from lightgaussian_tpu.data import colmap as jcolmap

    src, model, jscene_ = workspace
    # a COLMAP source whose cameras are the Blender source's
    colmap_src = tmp_path / "colmap"
    sparse = colmap_src / "sparse" / "0"
    sparse.mkdir(parents=True)
    blender = jds.read_blender_scene(src, eval_split=True)
    cams = blender.train_cameras + blender.test_cameras
    f = SIZE / (2.0 * math.tan(0.45))
    jcolmap.write_cameras_binary(sparse / "cameras.bin", {1: jcolmap.ColmapCamera(
        1, "PINHOLE", SIZE, SIZE, np.array([f, f, SIZE / 2, SIZE / 2]))})
    jcolmap.write_images_binary(sparse / "images.bin", {i + 1: jcolmap.ColmapImage(
        i + 1, jcolmap.rotmat2qvec(c.R.T), c.T, 1, f"{c.image_name}_{i}.png", np.zeros((0, 2)),
        np.zeros(0, np.int64)) for i, c in enumerate(cams)})
    jcolmap.write_points3D_binary(sparse / "points3D.bin", *jply.fetch_point_cloud(src / "points3d.ply")[:1],
                                  np.full((50, 3), 128))
    (colmap_src / "images").mkdir()
    for i, c in enumerate(cams):
        shutil.copy(c.image_path, colmap_src / "images" / f"{c.image_name}_{i}.png")
    shutil.copytree(colmap_src, tmp_path / "jcolmap")
    t_info = tds.read_scene(colmap_src, eval_split=True)
    j_info = jds.read_scene(tmp_path / "jcolmap", eval_split=True)
    assert len(t_info.test_cameras) == 1 and len(t_info.train_cameras) == 3
    for ct, cj in zip(t_info.train_cameras + t_info.test_cameras, j_info.train_cameras + j_info.test_cameras):
        assert ct.image_name == cj.image_name
        np.testing.assert_allclose(ct.R, cj.R, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(ct.T, cj.T)
        assert (ct.fovx, ct.fovy) == (cj.fovx, cj.fovy)
        # and the Blender reading of the same camera (its R is a float32 look-at, orthonormal to 1e-7)
        cb = cams[int(ct.image_name.split("_")[-1])]
        np.testing.assert_allclose(ct.R, cb.R, rtol=0, atol=1e-7)
        assert abs(ct.fovx - cb.fovx) < 1e-12
    # a fresh run starts from the point cloud, as the JAX Scene does
    fresh = tscene.Scene(str(src), str(tmp_path / "fresh"), device="cpu")
    jfresh = jscene.Scene(str(src), str(tmp_path / "jfresh"), load_images=False)
    assert fresh.loaded_iter is None and int(fresh.gaussians.alive.sum()) == 50
    np.testing.assert_allclose(_np(fresh.gaussians.log_scales), np.asarray(jfresh.gaussians.log_scales),
                               rtol=1e-5, atol=1e-6)
    assert (tmp_path / "fresh" / "input.ply").read_bytes() == (src / "points3d.ply").read_bytes()
    assert json.loads((tmp_path / "fresh" / "cameras.json").read_text()) == json.loads(
        (tmp_path / "jfresh" / "cameras.json").read_text())
    # load_vq: a JAX bundle under the next iteration, read by both Scenes and served by both CLIs
    m = tmp_path / "vq_model"
    shutil.copytree(model, m)
    cfg = jvt.VQConfig(sh_degree=jscene_.max_sh_degree, codebook_size=64, iterations=10, chunk=128)
    jvt.quantize_scene(jscene_, np.linspace(0.0, 1.0, 300), m / "vq", cfg)
    shutil.copytree(m / "vq" / "extreme_saving", m / "point_cloud" / f"iteration_{ITER + 1}" / "extreme_saving")
    kw = dict(eval_split=True, load_iteration=ITER + 1, shuffle=False, load_vq=True)
    t = tscene.Scene(str(src), str(m), device="cpu", **kw)
    j = jscene.Scene(str(src), str(m), **kw)
    for fld in FIELDS:
        np.testing.assert_array_equal(_np(getattr(t.gaussians, fld)), np.asarray(getattr(j.gaussians, fld)),
                                      err_msg=fld)
    mj = tmp_path / "vq_model_jax"
    shutil.copytree(m, mj)
    tcli.main(["-s", str(src), "-m", str(m), "--quiet", "--device", "cpu", "--load_vq", "--eval", "--skip_train"])
    jcli.main(["-s", str(src), "-m", str(mj), "--quiet", "--interpret", "--load_vq", "--eval", "--skip_train"])
    got = _pngs(m / "test" / f"ours_{ITER + 1}" / "renders")
    want = _pngs(mj / "test" / f"ours_{ITER + 1}" / "renders")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1 and g.std() > 1.0


@pytest.mark.parametrize("argv", [[], ["-w"], ["--resolution", "2"], ["--eval", "--images", "imgs", "--skip_test"]])
def test_render_cli_arguments_match_jax(tmp_path, argv):
    """Flags and the merge of a saved cfg_args.json (explicit flags win)."""
    from lightgaussian_tpu.cli import common as jcommon
    from lightgaussian_tpu.cli import render_sets as jcli
    from lightgaussian_tpu_torch.cli import common as tcommon

    (tmp_path / "cfg_args.json").write_text(json.dumps({
        "model": {"white_background": True, "resolution": 4, "sh_degree": 2},
        "pipeline": {"debug": True}, "seed": 3,
    }))
    full = ["-m", str(tmp_path), "-s", "src"] + argv
    j = jcommon.get_combined_args(jcli.build_parser(), full)
    t = tcommon.get_combined_args(tcli.build_parser(), full)
    shared = (set(vars(t)) & set(vars(j))) - {"data_device"}
    assert set(vars(t)) - set(vars(j)) == {"device"} and set(vars(j)) - set(vars(t)) == {"interpret"}
    assert {k: getattr(t, k) for k in shared} == {k: getattr(j, k) for k in shared}
    assert t.white_background and t.resolution == (2 if "2" in argv else 4)


# ---- the render CLI -------------------------------------------------------------

def _pngs(d: Path) -> list[np.ndarray]:
    files = sorted(d.glob("*.png"))
    return [np.asarray(Image.open(p)).astype(np.int16) for p in files]


def test_render_cli_matches_jax(workspace, tmp_path):
    import shutil

    from lightgaussian_tpu.cli import render_sets as jcli

    src, model, _ = workspace
    mj, mt = tmp_path / "jax_model", tmp_path / "torch_model"
    shutil.copytree(model, mj)
    shutil.copytree(model, mt)
    jcli.main(["-s", str(src), "-m", str(mj), "--eval", "--quiet", "--interpret"])
    tcli.main(["-s", str(src), "-m", str(mt), "--eval", "--quiet", "--device", "cpu"])
    for split in ("train", "test"):
        for kind in ("renders", "gt"):
            want = _pngs(mj / split / f"ours_{ITER}" / kind)
            got = _pngs(mt / split / f"ours_{ITER}" / kind)
            assert len(got) == len(want) == 2, (split, kind)
            for g, w in zip(got, want):
                assert g.shape == w.shape == (SIZE, SIZE, 3)
                if kind == "gt":
                    np.testing.assert_array_equal(g, w)
                else:
                    assert np.abs(g - w).max() <= 1
                    assert g.std() > 1.0  # not blank


# ---- devices and imports ------------------------------------------------------

def test_cuda_asked_for_and_absent_raises(workspace, monkeypatch):
    src, model, _ = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsyn.random_scene(n=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tply.load_gaussian_ply(model / "point_cloud" / f"iteration_{ITER}" / "point_cloud.ply")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["-s", str(src), "-m", str(model), "--quiet"])
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_cpu_run_never_touches_cuda(workspace, tmp_path, monkeypatch):
    import shutil

    src, model, _ = workspace

    def forbidden(*args, **kwargs):
        raise AssertionError("CUDA touched on a CPU run")

    for name in ("is_available", "_lazy_init", "current_stream", "synchronize", "device"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    m = tmp_path / "model"
    shutil.copytree(model, m)
    tcli.main(["-s", str(src), "-m", str(m), "--eval", "--quiet", "--skip_train", "--device", "cpu"])
    assert len(list((m / "test" / f"ours_{ITER}" / "renders").glob("*.png"))) == 2


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lightgaussian_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lightgaussian_tpu'))\n"
        "new = {'compress.vq', 'compress.vectree', 'data.colmap', 'eval.lpips', 'eval.metrics', 'utils.threefry',\n"
        "       'cli.convert', 'cli.vectree', 'cli.metrics', 'cli.full_eval'}\n"
        "missing = sorted(new - {m.split('.', 1)[1] for m in mods})\n"
        "print(len(mods), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(mods) < 62 else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Alone in a directory, or without a card, the smoke run exits non-zero
    and prints no result line. The card is hidden, so this holds on any host."""
    import shutil

    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for cwd, script in ((tmp_path, tmp_path / "chip_smoke.py"), (REPO, REPO / "chip_smoke.py")):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
