"""PyTorch port vs the JAX package: COLMAP input and the `convert` CLI.

Held on the CPU:
- the binary writers: the port's files byte-equal to the JAX package's;
- the binary and text readers of both packages on the same files: equal
  records (cameras, images with their 2D points and point ids, points);
- `qvec2rotmat` / `rotmat2qvec`: within 1e-12 of the JAX package's;
- `read_colmap_scene` (binary and text sources): equal cameras (R, T and
  the fields of view within 1e-12, names, sizes, the `llffhold` split),
  the same point cloud and the same cached `points3D.ply` bytes; the
  cameras a `Scene` loads from it equal the JAX Scene's;
- a truncated `images.bin` or `points3D.bin` is refused;
- the `convert` CLI with a fake `colmap` binary: the JAX CLI's argument
  lists, stage for stage, and the sparse/ -> sparse/0 move; a missing
  binary exits 1; the pyramids equal the JAX CLI's.
"""
import os
import stat

import numpy as np
import pytest
import torch
from PIL import Image

from lightgaussian_tpu.cli import convert as jconvert
from lightgaussian_tpu.data import colmap as jcolmap
from lightgaussian_tpu.data import dataset as jds
from lightgaussian_tpu.data import scene as jscene
from lightgaussian_tpu_torch.cli import convert as tconvert
from lightgaussian_tpu_torch.data import colmap as tcolmap
from lightgaussian_tpu_torch.data import dataset as tds
from lightgaussian_tpu_torch.data import scene as tscene

torch.set_num_threads(1)


def _records(rng, n_images, width, height, n_points):
    cams = {1: (1, "PINHOLE", width, height, np.array([60.0, 55.0, width / 2, height / 2])),
            2: (2, "SIMPLE_PINHOLE", width, height, np.array([58.0, width / 2, height / 2]))}
    images = {}
    for i in range(1, n_images + 1):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        if q[0] < 0:
            q = -q
        m = int(rng.integers(1, 9))
        images[i] = (i, q, rng.normal(size=3), 1 + i % 2, f"img_{(7 * i) % n_images:03d}.png",
                     rng.normal(size=(m, 2)), rng.integers(-1, 1000, m).astype(np.int64))
    return cams, images, rng.normal(size=(n_points, 3)), rng.integers(0, 256, (n_points, 3))


def _write(mod, sparse, cams, images, xyz, rgb):
    sparse.mkdir(parents=True, exist_ok=True)
    mod.write_cameras_binary(sparse / "cameras.bin", {k: mod.ColmapCamera(*v) for k, v in cams.items()})
    mod.write_images_binary(sparse / "images.bin", {k: mod.ColmapImage(*v) for k, v in images.items()})
    mod.write_points3D_binary(sparse / "points3D.bin", xyz, rgb)


def _write_text(sparse, cams, images, xyz, rgb):
    sparse.mkdir(parents=True, exist_ok=True)
    (sparse / "cameras.txt").write_text("# cameras\n" + "".join(
        f"{c[0]} {c[1]} {c[2]} {c[3]} {' '.join(repr(float(p)) for p in c[4])}\n" for c in cams.values()))
    lines = ["# images"]
    for im in images.values():
        lines.append(f"{im[0]} {' '.join(repr(float(v)) for v in (*im[1], *im[2]))} {im[3]} {im[4]}")
        lines.append(" ".join(f"{x!r} {y!r} {int(p)}" for (x, y), p in zip(im[5].tolist(), im[6])))
    (sparse / "images.txt").write_text("\n".join(lines) + "\n")
    (sparse / "points3D.txt").write_text("# points\n" + "".join(
        f"{i + 1} {' '.join(repr(float(v)) for v in p)} {' '.join(str(int(c)) for c in col)} 0.5 1 0\n"
        for i, (p, col) in enumerate(zip(xyz, rgb))))


def _source(root, rng, n_images=10, width=64, height=48, text=False):
    cams, images, xyz, rgb = _records(rng, n_images, width, height, 40)
    sparse = root / "sparse" / "0"
    if text:
        _write_text(sparse, cams, images, xyz, rgb)
    else:
        _write(jcolmap, sparse, cams, images, xyz, rgb)
    (root / "images").mkdir(parents=True)
    for im in images.values():
        Image.fromarray(rng.integers(0, 256, (height, width, 3), dtype=np.uint8)).save(root / "images" / im[4])
    return cams, images, xyz, rgb


def _assert_images_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert (g.id, g.camera_id, g.name) == (w.id, w.camera_id, w.name)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(np.asarray(getattr(g, f)), np.asarray(getattr(w, f)), err_msg=f)


def test_binary_writers_and_readers_match_jax(tmp_path, rng):
    recs = _records(rng, 6, 64, 48, 40)
    _write(jcolmap, tmp_path / "j", *recs)
    _write(tcolmap, tmp_path / "t", *recs)
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    d = tmp_path / "j"
    tc, jc = tcolmap.read_cameras_binary(d / "cameras.bin"), jcolmap.read_cameras_binary(d / "cameras.bin")
    assert set(tc) == set(jc) == {1, 2}
    for k in jc:
        assert (tc[k].model, tc[k].width, tc[k].height) == (jc[k].model, jc[k].width, jc[k].height)
        np.testing.assert_array_equal(tc[k].params, jc[k].params)
    _assert_images_equal(tcolmap.read_images_binary(d / "images.bin"), jcolmap.read_images_binary(d / "images.bin"))
    for got, want in zip(tcolmap.read_points3D_binary(d / "points3D.bin"),
                         jcolmap.read_points3D_binary(d / "points3D.bin")):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_text_readers_match_jax(tmp_path, rng):
    recs = _records(rng, 5, 64, 48, 30)
    _write_text(tmp_path, *recs)
    tc, jc = tcolmap.read_cameras_text(tmp_path / "cameras.txt"), jcolmap.read_cameras_text(tmp_path / "cameras.txt")
    assert {k: (c.model, c.width, c.height, tuple(c.params)) for k, c in tc.items()} == \
        {k: (c.model, c.width, c.height, tuple(c.params)) for k, c in jc.items()}
    _assert_images_equal(tcolmap.read_images_text(tmp_path / "images.txt"),
                         jcolmap.read_images_text(tmp_path / "images.txt"))
    for got, want in zip(tcolmap.read_points3D_text(tmp_path / "points3D.txt"),
                         jcolmap.read_points3D_text(tmp_path / "points3D.txt")):
        np.testing.assert_array_equal(got, want)


def test_text_image_without_points(tmp_path, rng):
    """COLMAP writes an empty points line for an image without 2D points.
    The port reads it; the JAX reader skips the blank line and takes the
    next image's line for the points (a fault of the reference, ROADMAP.md
    section C)."""
    cams, images, xyz, rgb = _records(rng, 4, 64, 48, 10)
    images[2] = images[2][:5] + (np.zeros((0, 2)), np.zeros(0, np.int64))
    _write_text(tmp_path, cams, images, xyz, rgb)
    got = tcolmap.read_images_text(tmp_path / "images.txt")
    want = {k: tcolmap.ColmapImage(*v) for k, v in images.items()}
    _assert_images_equal(got, want)
    with pytest.raises(ValueError):
        jcolmap.read_images_text(tmp_path / "images.txt")


def test_qvec_rotmat_match_jax(rng):
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = tcolmap.qvec2rotmat(q)
        np.testing.assert_allclose(R, jcolmap.qvec2rotmat(q), rtol=0, atol=1e-12)
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-12)
        np.testing.assert_allclose(tcolmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R), rtol=0, atol=1e-12)


@pytest.mark.parametrize("truncate", ["images.bin", "points3D.bin"])
def test_truncated_binary_file_refused(tmp_path, rng, truncate):
    _write(tcolmap, tmp_path, *_records(rng, 5, 64, 48, 200))
    raw = (tmp_path / truncate).read_bytes()
    (tmp_path / "bad.bin").write_bytes(raw[: len(raw) // 2])
    reader = tcolmap.read_images_binary if truncate == "images.bin" else tcolmap.read_points3D_binary
    with pytest.raises(ValueError, match="ends"):
        reader(tmp_path / "bad.bin")


@pytest.mark.parametrize("text", [False, True])
@pytest.mark.parametrize("eval_split", [False, True])
def test_read_colmap_scene_matches_jax(tmp_path, rng, text, eval_split):
    src = tmp_path / "scene"
    _source(src, rng, text=text)
    # each package converts the points once; run them on copies so both convert
    import shutil

    jsrc = tmp_path / "jscene"
    shutil.copytree(src, jsrc)
    t = tds.read_scene(src, eval_split=eval_split)
    j = jds.read_scene(jsrc, eval_split=eval_split)
    assert (src / "sparse/0/points3D.ply").read_bytes() == (jsrc / "sparse/0/points3D.ply").read_bytes()
    for ts, js in ((t.train_cameras, j.train_cameras), (t.test_cameras, j.test_cameras)):
        assert [c.image_name for c in ts] == [c.image_name for c in js]
        for ct, cj in zip(ts, js):
            np.testing.assert_allclose(ct.R, cj.R, rtol=0, atol=1e-12)
            np.testing.assert_allclose(ct.T, cj.T, rtol=0, atol=1e-12)
            assert abs(ct.fovx - cj.fovx) < 1e-12 and abs(ct.fovy - cj.fovy) < 1e-12
            assert (ct.uid, ct.width, ct.height) == (cj.uid, cj.width, cj.height)
            assert os.path.basename(ct.image_path) == os.path.basename(cj.image_path)
    assert len(t.test_cameras) == (2 if eval_split else 0)  # every 8th of 10 sorted names
    names = [c.image_name for c in t.train_cameras + t.test_cameras]
    assert sorted(names) == sorted(f"img_{i:03d}" for i in range(10))
    for got, want in zip(t.point_cloud, j.point_cloud):
        np.testing.assert_array_equal(got, want)
    assert t.nerf_normalization["radius"] == pytest.approx(j.nerf_normalization["radius"], rel=1e-12)
    np.testing.assert_allclose(t.nerf_normalization["translate"], j.nerf_normalization["translate"], atol=1e-12)


def test_scene_from_colmap_matches_jax(tmp_path, rng):
    src = tmp_path / "scene"
    _source(src, rng)
    kw = dict(eval_split=True, shuffle=False)
    t = tscene.Scene(str(src), str(tmp_path / "tmodel"), device="cpu", **kw)
    j = jscene.Scene(str(src), str(tmp_path / "jmodel"), **kw)
    assert (tmp_path / "tmodel" / "cameras.json").read_text() == (tmp_path / "jmodel" / "cameras.json").read_text()
    assert t.cameras_extent == pytest.approx(j.cameras_extent, rel=1e-12)
    for ts, js in ((t.getTrainCameras(), j.getTrainCameras()), (t.getTestCameras(), j.getTestCameras())):
        assert len(ts) == len(js) > 0
        for ct, cj in zip(ts, js):
            for f in ("world_view", "full_proj", "camera_center", "gt_image"):
                np.testing.assert_allclose(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)), rtol=1e-6, atol=1e-6,
                                           err_msg=f)
    np.testing.assert_allclose(t.gaussians.log_scales.numpy()[:40], np.asarray(j.gaussians.log_scales)[:40],
                               rtol=1e-5, atol=1e-6)


def _fake_colmap_binary(tmp_path, monkeypatch):
    log = tmp_path / "calls.log"
    stub_dir = tmp_path / "bin"
    stub_dir.mkdir()
    stub = stub_dir / "colmap"
    stub.write_text(f"""#!/bin/bash
echo "$@" >> {log}
if [ "$1" = image_undistorter ]; then
  out=""
  prev=""
  for a in "$@"; do [ "$prev" = --output_path ] && out="$a"; prev="$a"; done
  mkdir -p "$out/sparse" "$out/images"
  touch "$out/sparse/cameras.bin" "$out/sparse/images.bin" "$out/sparse/points3D.bin"
fi
exit 0
""")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{stub_dir}:{os.environ['PATH']}")
    return log


@pytest.mark.parametrize("flags", [["--no_gpu"], ["--camera", "PINHOLE"], ["--skip_matching"]])
def test_convert_cli_runs_the_jax_stages(tmp_path, monkeypatch, flags):
    log = _fake_colmap_binary(tmp_path, monkeypatch)
    calls = {}
    for name, run in (("jax", lambda s: jconvert.main(["-s", str(s), *flags])),
                      ("torch", lambda s: tconvert.main(["-s", str(s), *flags, "--device", "cpu"]))):
        scene = tmp_path / name
        (scene / "input").mkdir(parents=True)
        if log.exists():
            log.unlink()
        run(scene)
        calls[name] = log.read_text().replace(str(scene), "<scene>").strip().split("\n")
        for f in ("cameras.bin", "images.bin", "points3D.bin"):
            assert (scene / "sparse" / "0" / f).exists()
    assert calls["torch"] == calls["jax"]
    stages = [c.split()[0] for c in calls["torch"]]
    assert stages == (["image_undistorter"] if "--skip_matching" in flags
                      else ["feature_extractor", "exhaustive_matcher", "mapper", "image_undistorter"])


def test_convert_cli_refuses_and_resizes(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no colmap anywhere
    with pytest.raises(SystemExit) as e:
        tconvert.main(["-s", str(tmp_path), "--colmap_executable", "definitely_missing", "--device", "cpu"])
    assert e.value.code == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        tconvert.main(["-s", str(tmp_path)])
    for d in ("j", "t"):
        (tmp_path / d / "images").mkdir(parents=True)
        arr = (np.random.default_rng(0).random((32, 48, 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(tmp_path / d / "images" / "a.png")
    jconvert.build_pyramids(tmp_path / "j")
    tconvert.build_pyramids(tmp_path / "t")
    for sub in ("images_2", "images_4", "images_8"):
        assert (tmp_path / "t" / sub / "a.png").read_bytes() == (tmp_path / "j" / sub / "a.png").read_bytes()
    jflags = {a.dest: a.default for a in jconvert.build_parser()._actions if a.dest != "help"}
    tflags = {a.dest: a.default for a in tconvert.build_parser()._actions if a.dest != "help"}
    assert tflags == {**jflags, "device": "cuda"}
