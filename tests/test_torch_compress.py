"""PyTorch port vs the JAX package: VecTree compression.

Both packages draw from the same `jax.random` streams (the port's
`utils/threefry.py`), so from the same seed they fit the same codebook on
the same batches. Held on the CPU:
- bit packing: the port's packer and unpacker against the JAX package's;
- `nearest_code`: indices equal on seeded data;
- one EMA step from one state, chunk and weights (carried across with
  `convert.codebook_state_from_numpy`): within 1e-5, with all-ones weights
  (ties in both top-k choices), a zero-importance chunk, and k_expire 0;
- `train_codebook`'s loop at K 64, chunk 128, 50 iterations, step by step
  from the JAX fit's state: the same sampled indices, the same nearest
  codes except where two codes lie within 1e-5 of each other's distance
  (near-duplicate codes: codes start as drawn data rows and expired codes
  become chunk rows, so a sampled row can sit on two codes; float32
  rounding of |x|^2 - 2 x.e + |e|^2 decides such a tie, differently in XLA
  and in torch), and each step without such a tie within 1e-5; the port's
  whole fit as good as the JAX fit (quantization error within 10%), since
  the first tie sends the two fits apart;
- `quantize_scene` on the same scene, importance and seed: the same seven
  files; the keep mask, the kept features, the other attributes, xyz and
  the metadata bit-equal to the JAX bundle's; the JAX fit's result written
  by the port's writer bit-equal in every array (the files' bytes differ:
  `np.savez_compressed` stamps the time);
- a JAX bundle loaded by the port and the port's by JAX;
- the quantized SH error under a quarter of a random codebook's, and a
  zero-importance scene finite;
- the `vectree` CLI against the JAX CLI on the same PLY and scores.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.compress import vectree as jvt
from lightgaussian_tpu.compress import vq as jvq
from lightgaussian_tpu.data import ply as jply
from lightgaussian_tpu.models import gaussians as JG
from lightgaussian_tpu_torch import convert
from lightgaussian_tpu_torch.compress import vectree as tvt
from lightgaussian_tpu_torch.compress import vq as tvq
from lightgaussian_tpu_torch.models import gaussians as TG
from lightgaussian_tpu_torch.utils import threefry as tf

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _state_from_jax(s):
    return convert.codebook_state_from_numpy(s.embed, s.embed_avg, s.cluster_size, device="cpu")


def _assert_state_close(t, j, atol):
    got = convert.codebook_state_to_numpy(t)
    for k in ("embed", "embed_avg", "cluster_size"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(j, k)), rtol=0, atol=atol, err_msg=k)


def _scenes(rng, n=300, max_sh=2):
    """One seeded scene in both packages (the JAX suite's toy scene)."""
    k = (max_sh + 1) ** 2 - 1
    arrays = dict(means=rng.normal(size=(n, 3)), sh_dc=rng.normal(size=(n, 3)),
                  sh_rest=rng.normal(size=(n, k, 3)) * 0.1, log_scales=rng.normal(size=(n, 3)),
                  quats=rng.normal(size=(n, 4)), opacity_logits=rng.normal(size=(n,)))
    arrays = {f: np.asarray(v, np.float32) for f, v in arrays.items()}
    cap = JG.round_capacity(n)
    js = JG.empty_scene(cap, max_sh_degree=max_sh, active_sh_degree=max_sh)
    js = dataclasses.replace(js, alive=js.alive.at[:n].set(True),
                             **{f: getattr(js, f).at[:n].set(jnp.asarray(v)) for f, v in arrays.items()})
    ts = TG.fill_scene(TG.empty_scene(cap, max_sh, max_sh, device="cpu"), arrays, n)
    return js, ts


@pytest.mark.parametrize("bits", [1, 4, 13])
def test_pack_bits_match_jax(rng, bits):
    vals = rng.integers(0, 2**bits, 999)
    packed = tvt.pack_bits_msb(vals, bits)
    np.testing.assert_array_equal(packed, jvt.pack_bits_msb(vals, bits))
    np.testing.assert_array_equal(tvt.unpack_bits_msb(packed, 999, bits), vals)
    np.testing.assert_array_equal(jvt.unpack_bits_msb(packed, 999, bits), vals)


def test_nearest_code_matches_jax(rng):
    feats = rng.normal(size=(500, 27)).astype(np.float32)
    embed = rng.normal(size=(64, 27)).astype(np.float32)
    want = np.asarray(jvq.nearest_code(jnp.asarray(feats), jnp.asarray(embed)))
    np.testing.assert_array_equal(tvq.nearest_code(_t(feats), _t(embed)).numpy(), want)
    # a duplicated code: the first index wins in both
    embed[5] = embed[9]
    want = np.asarray(jvq.nearest_code(jnp.asarray(feats), jnp.asarray(embed)))
    got = tvq.nearest_code(_t(feats), _t(embed)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 9 not in got


@pytest.mark.parametrize("case", ["weighted", "all_ones", "zero_importance", "no_expire"])
def test_ema_step_matches_jax(rng, case):
    k_codes, dim, chunk = 64, 27, 256
    feats = rng.normal(size=(chunk, dim)).astype(np.float32)
    weight = {"weighted": rng.random(chunk), "all_ones": np.ones(chunk), "zero_importance": np.zeros(chunk),
              "no_expire": rng.random(chunk)}[case].astype(np.float32)
    k_expire = 0 if case == "no_expire" else 10
    j0 = jvq.init_codebook(jax.random.PRNGKey(3), k_codes, dim, feats=jnp.asarray(feats))
    if case == "weighted":  # uneven cluster sizes
        j0 = dataclasses.replace(j0, cluster_size=jnp.asarray(rng.random(k_codes) * 3, jnp.float32))
    t0 = _state_from_jax(j0)
    j1 = jvq._ema_step(j0, jnp.asarray(feats), jnp.asarray(weight), k_expire)
    t1 = tvq._ema_step(t0, _t(feats), _t(weight), k_expire)
    _assert_state_close(t1, j1, 1e-5)
    if case != "no_expire":  # the revived codes are the same chunk rows, exactly
        revived = [i for i, row in enumerate(np.asarray(j1.embed)) if (row == feats).all(axis=1).any()]
        assert len(revived) >= 10
        np.testing.assert_array_equal(t1.embed.numpy()[revived], np.asarray(j1.embed)[revived])


def test_init_codebook_matches_jax(rng):
    feats = rng.normal(size=(300, 27)).astype(np.float32)
    for feats_j, feats_t in ((jnp.asarray(feats), _t(feats)), (None, None)):
        j = jvq.init_codebook(jax.random.PRNGKey(5), 64, 27, feats=feats_j)
        t = tvq.init_codebook(tf.prng_key(5), 64, 27, feats=feats_t, device="cpu")
        _assert_state_close(t, j, 0.0)


def _quant_error(feats, embed):
    idx = tvq.nearest_code(_t(feats), _t(embed)).numpy()
    return float(np.mean((np.asarray(embed)[idx] - feats) ** 2))


def test_train_codebook_matches_jax(rng):
    feats = rng.normal(size=(300, 27)).astype(np.float32)
    imp = rng.random(300).astype(np.float32)
    iterations, chunk, k_expire = 50, 128, 10
    key = jax.random.PRNGKey(0)
    j0 = jvq.init_codebook(key, 64, 27, feats=jnp.asarray(feats))
    subs = tvq.sample_keys(tf.prng_key(0), iterations)
    j, k, ties, clean = j0, key, 0, 0
    for i in range(iterations):
        k, sub = jax.random.split(k)
        idx = np.asarray(jax.random.randint(sub, (chunk,), 0, 300))
        np.testing.assert_array_equal(tf.randint(subs[i], (chunk,), 0, 300).numpy(), idx)
        x = feats[idx]
        t_in = _state_from_jax(j)
        jn = np.asarray(jvq.nearest_code(jnp.asarray(x), j.embed))
        tn = tvq.nearest_code(_t(x), t_in.embed).numpy()
        e = np.asarray(j.embed, np.float64)
        for r in np.flatnonzero(jn != tn):
            d = ((x[r].astype(np.float64) - e[[jn[r], tn[r]]]) ** 2).sum(axis=1)
            assert abs(d[0] - d[1]) < 1e-5, (i, r, d)
            ties += 1
        j_next = jvq._ema_step(j, jnp.asarray(x), jnp.asarray(imp[idx]), k_expire)
        if (jn == tn).all():
            _assert_state_close(tvq._ema_step(t_in, _t(x), _t(imp[idx]), k_expire), j_next, 1e-5)
            clean += 1
        j = j_next
    assert clean >= 10 and ties > 0, (clean, ties)
    # the whole fits: the same quality
    jfit = jvq.train_codebook(key, j0, jnp.asarray(feats), jnp.asarray(imp), iterations=iterations, chunk=chunk)
    tfit = tvq.train_codebook(tf.prng_key(0), _state_from_jax(j0), _t(feats), _t(imp), iterations=iterations,
                              chunk=chunk)
    err_j, err_t = _quant_error(feats, np.asarray(jfit.embed)), _quant_error(feats, tfit.embed.numpy())
    assert abs(err_t - err_j) < 0.1 * err_j, (err_t, err_j)


def _bundle_arrays(d):
    out = {}
    for f in tvt.BUNDLE_FILES:
        with np.load(d / f, allow_pickle=True) as z:
            out[f] = {k: z[k] for k in z.files}
    return out


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    rng = np.random.default_rng(0)
    js, ts = _scenes(rng, n=300)
    imp = rng.random(300).astype(np.float32)
    cfg = dict(sh_degree=2, vq_ratio=0.6, codebook_size=64, iterations=50, chunk=128)
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
    jres, jdeq = jvt.quantize_scene(js, imp, jdir, jvt.VQConfig(**cfg), seed=0)
    tres, tdeq = tvt.quantize_scene(ts, imp, tdir, tvt.VQConfig(**cfg), seed=0)
    return dict(js=js, ts=ts, imp=imp, jdir=jdir, tdir=tdir, jres=jres, tres=tres, jdeq=jdeq, tdeq=tdeq)


def test_bundle_arrays_match_jax(bundles, tmp_path):
    b = bundles
    assert sorted(p.name for p in (b["tdir"] / "extreme_saving").iterdir()) == sorted(tvt.BUNDLE_FILES)
    assert (b["tdir"] / "extreme_saving.zip").stat().st_size > 0 and b["tres"].size_mb > 0
    jarr, tarr = _bundle_arrays(b["jdir"] / "extreme_saving"), _bundle_arrays(b["tdir"] / "extreme_saving")
    fit_free = ("metadata.npz", "non_vq_mask.npz", "non_vq_feats.npz", "other_attribute.npz", "xyz.npz")
    for f in tvt.BUNDLE_FILES:
        assert sorted(tarr[f]) == sorted(jarr[f]), f
        for k in jarr[f]:
            assert tarr[f][k].dtype == jarr[f][k].dtype and tarr[f][k].shape == jarr[f][k].shape, (f, k)
            if f == "metadata.npz":
                assert tarr[f][k].item() == jarr[f][k].item()
            elif f in fit_free:
                np.testing.assert_array_equal(tarr[f][k], jarr[f][k], err_msg=f)
    np.testing.assert_array_equal(b["tres"].non_vq_mask, b["jres"].non_vq_mask)
    assert b["tres"].non_vq_mask.sum() == int(300 * 0.4)
    assert b["imp"][b["tres"].non_vq_mask].min() >= b["imp"][~b["tres"].non_vq_mask].max()
    # the JAX fit's result through the port's writer: every array bit-equal
    cfg = tvt.VQConfig(sh_degree=2, vq_ratio=0.6, codebook_size=64, iterations=50, chunk=128)
    tvt.save_extreme(tmp_path, tvt.scene_to_feature_matrix(b["ts"]), b["jres"], cfg)
    warr = _bundle_arrays(tmp_path / "extreme_saving")
    for f in tvt.BUNDLE_FILES[1:]:
        np.testing.assert_array_equal(warr[f]["arr_0"], jarr[f]["arr_0"], err_msg=f)
    # the port's own fit: a finite codebook as good as the JAX fit's on the VQ rows
    vq_rows = tvt.scene_to_feature_matrix(b["ts"])[~b["tres"].non_vq_mask, 6:33]
    assert np.isfinite(b["tres"].codebook).all()
    err_j, err_t = _quant_error(vq_rows, b["jres"].codebook), _quant_error(vq_rows, b["tres"].codebook)
    assert err_t < 1.1 * err_j, (err_t, err_j)


def test_bundles_load_across_packages(bundles):
    b = bundles
    # the JAX bundle read by the port, the port's by JAX: the same matrix as each package's own reader
    np.testing.assert_array_equal(tvt.load_extreme(b["jdir"] / "extreme_saving"),
                                  jvt.load_extreme(b["jdir"] / "extreme_saving"))
    np.testing.assert_array_equal(jvt.load_extreme(b["tdir"] / "extreme_saving"),
                                  tvt.load_extreme(b["tdir"] / "extreme_saving"))
    scene = tvt.load_vq_scene(b["jdir"] / "extreme_saving", device="cpu")
    jscene = jvt.load_vq_scene(b["tdir"] / "extreme_saving")
    for f in TG.GaussianScene.PARAM_FIELDS + ("alive",):
        np.testing.assert_array_equal(getattr(scene, f).numpy(), np.asarray(getattr(b["jdeq"], f)), err_msg=f)
        np.testing.assert_array_equal(getattr(b["tdeq"], f).numpy(), np.asarray(getattr(jscene, f)), err_msg=f)
    # xyz exact, kept SH and the other attributes fp16-exact, VQ rows codebook rows
    feats = tvt.scene_to_feature_matrix(b["ts"])
    full = tvt.load_extreme(b["tdir"] / "extreme_saving")
    keep = b["tres"].non_vq_mask
    np.testing.assert_array_equal(full[:, 0:3], feats[:, 0:3])
    np.testing.assert_array_equal(full[keep, 6:33], feats[keep, 6:33].astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(full[:, -8:], feats[:, -8:].astype(np.float16).astype(np.float32))
    d = np.abs(full[~keep, 6:33][:, None, :] - b["tres"].codebook[None]).max(axis=2).min(axis=1)
    assert d.max() == 0.0


def test_feature_matrix_matches_jax(rng):
    js, ts = _scenes(rng, n=200)
    feats = tvt.scene_to_feature_matrix(ts)
    np.testing.assert_array_equal(feats, jvt.scene_to_feature_matrix(js))
    back = tvt.feature_matrix_to_scene(feats, device="cpu")
    jback = jvt.feature_matrix_to_scene(feats)
    assert back.max_sh_degree == jback.max_sh_degree == 2 and back.capacity == jback.alive.shape[0]
    for f in TG.GaussianScene.PARAM_FIELDS + ("alive",):
        np.testing.assert_array_equal(getattr(back, f).numpy(), np.asarray(getattr(jback, f)), err_msg=f)


def test_quantized_error_beats_random_codebook(rng):
    _, ts = _scenes(rng, n=500)
    feats = tvt.scene_to_feature_matrix(ts)
    cfg = tvt.VQConfig(sh_degree=2, vq_ratio=1.0, codebook_size=128, iterations=150, chunk=256)
    res, q = tvt.quantize_features(feats, np.ones(500, np.float32), cfg, seed=0, device="cpu")
    err = np.mean((q[:, 6:33] - feats[:, 6:33]) ** 2)
    rand_embed = tf.normal(tf.prng_key(9), (128, 27))  # the JAX suite's jax.random.normal codebook
    qrand, _ = tvq.quantize_with_fp16_codebook(_t(feats[:, 6:33]), rand_embed)
    err_rand = np.mean((qrand.numpy() - feats[:, 6:33]) ** 2)
    assert err < 0.25 * err_rand
    assert not res.non_vq_mask.any()


def test_zero_importance_scene_stays_finite(rng, tmp_path):
    _, ts = _scenes(rng, n=200)
    cfg = tvt.VQConfig(sh_degree=2, vq_ratio=0.6, codebook_size=64, iterations=20, chunk=128)
    res, deq = tvt.quantize_scene(ts, np.zeros(200, np.float32), tmp_path, cfg)
    assert np.isfinite(res.codebook).all()
    for f in ("sh_dc", "sh_rest"):
        assert torch.isfinite(getattr(deq, f)).all()
    with pytest.raises(ValueError, match="imp_score length"):
        tvt.quantize_scene(ts, np.zeros(7, np.float32), tmp_path, cfg)
    with pytest.raises(NotImplementedError, match="A10"):
        tvq.train_codebook_sharded()


def test_vectree_cli_matches_jax(rng, tmp_path):
    from lightgaussian_tpu.cli import vectree as jcli
    from lightgaussian_tpu_torch.cli import vectree as tcli

    js, _ = _scenes(rng, n=300, max_sh=3)
    ply = tmp_path / "point_cloud.ply"
    jply.save_gaussian_ply(js, ply)
    np.savez(tmp_path / "imp_score.npz", rng.random(300).astype(np.float32))
    flags = ["--important_score_npz_path", str(tmp_path), "--input_path", str(ply), "--iteration_num", "20",
             "--codebook_size", "64", "--vq_ratio", "0.5"]
    jcli.main([*flags, "--save_path", str(tmp_path / "j")])
    tcli.main([*flags, "--save_path", str(tmp_path / "t"), "--device", "cpu"])
    jarr, tarr = _bundle_arrays(tmp_path / "j" / "extreme_saving"), _bundle_arrays(tmp_path / "t" / "extreme_saving")
    for f in ("non_vq_mask.npz", "non_vq_feats.npz", "other_attribute.npz", "xyz.npz"):
        np.testing.assert_array_equal(tarr[f]["arr_0"], jarr[f]["arr_0"], err_msg=f)
    assert tarr["codebook.npz"]["arr_0"].shape == jarr["codebook.npz"]["arr_0"].shape == (64, 48)
    # the dequantized PLY: the port's bundle as the JAX package reads it
    deq = jply.load_gaussian_ply(tmp_path / "t" / "extreme_saving.ply")
    full = jvt.load_extreme(tmp_path / "t" / "extreme_saving")
    np.testing.assert_array_equal(np.asarray(deq.means)[:300], full[:, 0:3])
    np.testing.assert_array_equal(np.asarray(deq.sh_dc)[:300], full[:, 6:9])
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([*flags, "--save_path", str(tmp_path / "c")])
    jflags = {a.dest: a.default for a in jcli.build_parser()._actions if a.dest != "help"}
    tflags = {a.dest: a.default for a in tcli.build_parser()._actions if a.dest != "help"}
    assert tflags == {**jflags, "device": "cuda"}
