"""The preprocess kernels' CPU side: the backward's plain twin, the wrapper's
autograd node and its argument protocol, and the wrapper's refusals.

The kernels (`csrc/preprocess.cu`) run only on a card, where `chip_smoke.py`
holds the forward to the chain bit for bit and the backward to autograd of
the chain. Here:

- `projection.preprocess_backward_plain`, the arithmetic the backward kernel
  runs, against torch autograd of `plain_preprocess` and against JAX's VJP
  of the reference preprocess: 5e-5 after dividing by the reference
  gradient's largest magnitude, the JAX suite's gradient tolerance (the
  twin adds the chain rule's terms in its own order). Its cases cover every
  SH degree, K wider than the degree, the offset, precomputed colours and
  covariances, and Gaussians that are dead, behind the near plane, at the
  EWA's depth clamp, with det <= 0, and exactly on the colour clamp and on
  the 1.3 tan(fov) clamp, where autograd's masks decide (JAX splits a tie's
  gradient, so the JAX comparison leaves the stress set out);
- `projection._PreprocessFn`, the kernels' autograd node, with the two
  entry points' calls (`cuda_build.Kernel._launch`) replaced by fakes that
  rebuild every tensor from the pointers, strides and sizes they are passed
  and run the plain versions: so the argument lists, the nullable pointers,
  `needs_input_grad` and the table's launch counters are exercised as on
  the card;
- the wrapper refusing, before anything is built or launched, what the
  kernels do not take.
"""
import ctypes
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgaussian_tpu.ops.rasterize.projection import preprocess as jpreprocess
from lightgaussian_tpu.utils import synthetic as jsyn
from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.models.gaussians import GaussianScene
from lightgaussian_tpu_torch.ops.rasterize import projection as tp
from lightgaussian_tpu_torch.utils import cuda_build
from lightgaussian_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

TOL = 5e-5
W, H = 96, 64
SPLAT_GRADS = ("mean2d", "conic", "color", "opacity")
PARAMS = GaussianScene.PARAM_FIELDS


def _upstream(splats, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(getattr(splats, f).shape, generator=g) for f in SPLAT_GRADS]


def _autograd(scene, camera, up, scale_modifier=1.0, offset=False, colors=None, cov3d=None):
    """Autograd of the chain: {name: gradient or None} for the parameters and
    the given overrides."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in scene.params().items()}
    extra = {}
    if offset:
        extra["mean2d_offset"] = torch.zeros((scene.capacity, 2), requires_grad=True)
    if colors is not None:
        extra["colors_precomp"] = colors.detach().clone().requires_grad_(True)
    if cov3d is not None:
        extra["cov3d_precomp"] = cov3d.detach().clone().requires_grad_(True)
    s = tp.plain_preprocess(scene.with_params(params), camera, scale_modifier, extra.get("mean2d_offset"),
                            extra.get("colors_precomp"), extra.get("cov3d_precomp"))
    loss = sum((getattr(s, f) * g).sum() for f, g in zip(SPLAT_GRADS, up))
    leaves = {**params, **extra}
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return dict(zip(leaves, got))


def _hold(what, got, want):
    assert got.shape == want.shape, what
    assert torch.isfinite(want).all(), what
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / max(scale, 1e-30)
    assert err <= TOL, f"{what}: {err:.3e} of the largest |gradient| {scale:.3e}"


# name -> (scene kwargs, scale_modifier, offset, precomputed colours, precomputed covariances, stress set)
CASES = {
    "sh0": (dict(max_sh_degree=0), 1.0, False, False, False, False),
    "sh1_offset": (dict(max_sh_degree=1), 1.0, True, False, False, False),
    "sh2_of_sh3": (dict(max_sh_degree=3, active_sh_degree=2), 1.0, True, False, False, False),
    "sh3": (dict(max_sh_degree=3), 0.7, True, False, False, False),
    "sh4": (dict(max_sh_degree=4), 1.0, False, False, False, False),
    "sh0_of_sh4": (dict(max_sh_degree=4, active_sh_degree=0), 1.0, True, False, False, False),
    "colors_precomp": (dict(max_sh_degree=3), 1.0, True, True, False, False),
    "cov3d_precomp": (dict(max_sh_degree=2), 1.0, False, False, True, False),
    "stress_sh3": (dict(max_sh_degree=3), 1.0, True, False, False, True),
    "stress_sh1_cov3d": (dict(max_sh_degree=1), 1.0, True, False, True, True),
    "stress_sh4_colors": (dict(max_sh_degree=4), 1.3, False, True, False, True),
}


def _inputs(name, n=512, seed=1):
    kw, sm, offset, colors, cov3d, stress = CASES[name]
    if stress:
        scene, camera, cov6, _kind = tsyn.preprocess_stress(n, W, H, seed=seed, device="cpu", **kw)
    else:
        scene = tsyn.random_scene(n=n, seed=seed, device="cpu", **kw)
        camera = tsyn.default_camera(width=W, height=H, device="cpu")
        g = torch.Generator().manual_seed(seed)
        a = torch.randn((n, 3, 3), generator=g) * 0.05
        cov = a @ a.transpose(1, 2)
        cov6 = torch.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], 1)
    colors_t = torch.rand((n, 3), generator=torch.Generator().manual_seed(seed)) if colors else None
    return scene, camera, sm, offset, colors_t, cov6 if cov3d else None


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_twin_matches_autograd_of_the_chain(name):
    scene, camera, sm, offset, colors, cov3d = _inputs(name)
    s = tp.plain_preprocess(scene, camera, sm, None, colors, cov3d)
    up = _upstream(s, 3)
    want = _autograd(scene, camera, up, sm, offset, colors, cov3d)
    got = tp.preprocess_backward_plain(scene, camera, *up, scale_modifier=sm,
                                       mean2d_offset=torch.zeros((scene.capacity, 2)) if offset else None,
                                       colors_precomp=colors, cov3d_precomp=cov3d)
    for k, w in want.items():
        g = got[k]
        if w is None:  # the chain does not reach it: the twin gives None or zeros
            assert g is None or not g.any(), k
            continue
        if k == "sh_rest" and scene.active_sh_degree == 0:
            assert not w.any() and not g.any()
            continue
        _hold(f"{name}: {k}", g, w)
    assert (got["cov3d_precomp"] is None) == (cov3d is None)
    assert (got["colors_precomp"] is None) == (colors is None)
    if CASES[name][5]:  # the stress set reaches every mask
        valid = s.radius > 0
        assert not valid.all() and valid.any()
        assert (got["opacity_logits"][~valid] == 0).all()


def test_stress_set_sits_on_the_clamps():
    """The stress set holds Gaussians exactly on the colour clamp, on the
    1.3 tan(fov) clamp and on the depth clamp, and ones with det <= 0."""
    scene, camera, cov6, kind = tsyn.preprocess_stress(4096, W, H, seed=2, device="cpu")
    s = tp.plain_preprocess(scene, camera)
    assert (s.color == 0).sum() > 100
    z = torch.clamp(scene.means[:, 2], min=1e-6)
    lim = 1.3 * camera.tan_fovx
    assert ((scene.means[:, 0] / z) == lim).sum() > 10 and ((scene.means[:, 0] / z) == -lim).sum() > 10
    assert (scene.means[:, 2] == torch.tensor(1e-6)).sum() > 10
    s2 = tp.plain_preprocess(scene, camera, cov3d_precomp=cov6)
    ordinary = (kind == 0) & scene.alive
    assert ((s2.radius == 0) & ordinary).sum() > 10 and ((s2.radius > 0) & ordinary).sum() > 10


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_backward_twin_matches_jax_vjp(degree):
    """The twin against JAX's VJP of the JAX package's preprocess, on the
    same-seed scene (with the offset)."""
    n = 384
    kw = dict(n=n, seed=degree + 10, max_sh_degree=4, active_sh_degree=degree)
    jscene, tscene = jsyn.random_scene(**kw), tsyn.random_scene(device="cpu", **kw)
    jcam, tcam = jsyn.default_camera(width=W, height=H), tsyn.default_camera(width=W, height=H, device="cpu")
    s = tp.plain_preprocess(tscene, tcam)
    up = _upstream(s, degree)

    def f(params, offset):
        out = jpreprocess(jscene.with_params(params), jcam, mean2d_offset=offset)
        return out.mean2d, out.conic, out.color, out.opacity

    _, vjp = jax.vjp(f, jscene.params(), jnp.zeros((n, 2), jnp.float32))
    jparams, joffset = vjp(tuple(jnp.asarray(g.numpy()) for g in up))
    got = tp.preprocess_backward_plain(tscene, tcam, *up, mean2d_offset=torch.zeros((n, 2)))
    for k in PARAMS:
        want = torch.from_numpy(np.array(jparams[k]))
        if not want.any():
            assert not got[k].any(), k
            continue
        _hold(f"degree {degree}: {k}", got[k], want)
    _hold("mean2d_offset", got["mean2d_offset"], torch.from_numpy(np.array(joffset)))


# ---------------------------------------------------------------- the autograd node over fakes

_CTYPES = {torch.float32: ctypes.c_float, torch.bool: ctypes.c_bool, torch.int32: ctypes.c_int32}


def _view(ptr, shape, row_stride=None, dtype=torch.float32):
    """The tensor at `ptr`: `shape`, rows `row_stride` elements apart, each
    row contiguous (None for a null pointer)."""
    if ptr is None:
        return None
    inner = math.prod(shape[1:])
    row_stride = inner if row_stride is None else row_stride
    count = (shape[0] - 1) * row_stride + inner if shape and shape[0] else max(inner, 1)
    arr = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(_CTYPES[dtype])), shape=(count,))
    flat = torch.from_numpy(arr)
    if not shape:
        return flat[0]
    strides = [row_stride] + [math.prod(shape[i + 1:]) for i in range(1, len(shape))]
    return flat.as_strided(shape, strides)


def _rebuild(ptrs, strides, n, k, degree, width, height):
    """The scene, camera and overrides the kernels were handed."""
    shapes = ((n, 3), (n, 3), (n, 4), (n,), (n, 3), (n, k, 3), (n,), (n, 2), (n, 3), (n, 6))
    t = [_view(p, s, rs, torch.bool if i == 6 else torch.float32)
         for i, (p, s, rs) in enumerate(zip(ptrs[:10], shapes, strides))]
    cam = [_view(p, s) for p, s in zip(ptrs[10:15], ((4, 4), (4, 4), (3,), (), ()))]
    scene = GaussianScene(means=t[0], log_scales=t[1], quats=t[2], opacity_logits=t[3], sh_dc=t[4], sh_rest=t[5],
                          alive=t[6], active_sh_degree=degree, max_sh_degree=degree)
    camera = Camera(world_view=cam[0], full_proj=cam[1], camera_center=cam[2], tan_fovx=cam[3], tan_fovy=cam[4],
                    width=width, height=height)
    return scene, camera, t[7], t[8], t[9]


class FakeKernels:
    """`cuda_build.Kernel._launch` with each entry point run by its plain
    version on the tensors rebuilt from its arguments; records what it was
    given and returns no error."""

    def __init__(self):
        self.calls = []

    def __call__(self, kernel, like, args):
        self.calls.append((kernel.symbol, args))
        assert len(args) == len(kernel.argtypes) - 1  # all but the stream
        getattr(self, kernel.symbol)(*args)
        return 0

    def lg_preprocess_forward(self, *args):
        ptrs, ints, sm = args[:21], args[21:36], args[36]
        n, k, degree, width, height = ints[10:]
        scene, camera, offset, colors, cov3d = _rebuild(ptrs, ints[:10], n, k, degree, width, height)
        s = tp.plain_preprocess(scene, camera, sm, offset, colors, cov3d)
        shapes = ((n, 2), (n, 3), (n, 3), (n,), (n,), (n,))
        for f, p, shape in zip(("mean2d", "conic", "color", "opacity", "depth", "radius"), ptrs[15:21], shapes):
            _view(p, shape, dtype=torch.int32 if f == "radius" else torch.float32).copy_(getattr(s, f))

    def lg_preprocess_backward(self, *args):
        ptrs, ints, sm = args[:28], args[28:47], args[47]
        n, k, degree, width, height = ints[14:]
        scene, camera, offset, colors, cov3d = _rebuild(ptrs, ints[:10], n, k, degree, width, height)
        up = [_view(p, s, rs) for p, s, rs in zip(ptrs[15:19], ((n, 2), (n, 3), (n, 3), (n,)), ints[10:14])]
        up = [torch.zeros(s) if u is None else u for u, s in zip(up, ((n, 2), (n, 3), (n, 3), (n,)))]
        got = tp.preprocess_backward_plain(scene, camera, *up, scale_modifier=sm, mean2d_offset=offset,
                                           colors_precomp=colors, cov3d_precomp=cov3d)
        shapes = ((n, 3), (n, 3), (n, 4), (n,), (n, 3), (n, k, 3), (n, 2), (n, 3), (n, 6))
        for name, p, shape in zip(tp._GRADS, ptrs[19:28], shapes):
            if p is not None:
                _view(p, shape).copy_(got[name])


@pytest.fixture
def fakes(monkeypatch):
    fake = FakeKernels()
    monkeypatch.setattr(cuda_build.Kernel, "_launch", lambda kernel, like, args: fake(kernel, like, args))
    cuda_build.reset_launch_counts()
    return fake


def _counts():
    counts = cuda_build.launch_counts()
    return {k: counts[k] for k in ("preprocess_forward", "preprocess_backward")}


def _node(scene, camera, sm=1.0, offset=None, colors=None, cov3d=None):
    outs = tp._PreprocessFn.apply(scene.means, scene.log_scales, scene.quats, scene.opacity_logits, scene.sh_dc,
                                  scene.sh_rest, scene.alive, offset, colors, cov3d, camera,
                                  scene.active_sh_degree, float(sm))
    return tp.Splats(*outs)


class _PackedBlend(torch.autograd.Function):
    """A stand-in for the blend: a scalar whose backward gives the splats
    the columns of `packed`, as B2's [N, 9] gradients reach them."""

    @staticmethod
    def forward(ctx, packed, mean2d, conic, color, opacity):
        ctx.packed = packed
        return mean2d.new_zeros(())

    @staticmethod
    def backward(ctx, _g):
        p = ctx.packed
        return None, p[:, 0:2], p[:, 2:5], p[:, 5:8], p[:, 8]


# name -> (case of CASES, frozen parameters)
NODE_CASES = {
    "sh3_offset": ("sh3", ()),
    "sh2_of_sh3_distill": ("sh2_of_sh3", ("opacity_logits",)),
    "sh4_frozen_geometry": ("sh4", ("log_scales", "quats", "opacity_logits")),
    "sh0_of_sh4": ("sh0_of_sh4", ()),
    "colors_precomp": ("colors_precomp", ("sh_dc", "sh_rest")),
    "stress_cov3d": ("stress_sh1_cov3d", ("means",)),
}


@pytest.mark.parametrize("name", sorted(NODE_CASES))
def test_autograd_node_passes_what_the_kernels_take(name, fakes):
    case, frozen = NODE_CASES[name]
    scene, camera, sm, offset, colors, cov3d = _inputs(case, n=300)
    # sh_rest as the distillation student holds it: a view of the first rows of a wider array
    wide = torch.cat([scene.sh_rest, torch.ones((scene.capacity, 2, 3))], dim=1)
    scene = dataclasses.replace(scene, sh_rest=wide[:, :scene.sh_rest.shape[1]])
    params = {k: v.detach().clone().requires_grad_(k not in frozen) for k, v in scene.params().items()}
    params["sh_rest"] = wide.detach().clone()[:, :scene.sh_rest.shape[1]].requires_grad_("sh_rest" not in frozen)
    extra = {}
    if offset:
        extra["mean2d_offset"] = torch.zeros((scene.capacity, 2), requires_grad=True)
    if colors is not None:
        extra["colors_precomp"] = colors.clone().requires_grad_(True)
    if cov3d is not None:
        extra["cov3d_precomp"] = cov3d.clone().requires_grad_(True)
    live = scene.with_params(params)
    s = _node(live, camera, sm, extra.get("mean2d_offset"), extra.get("colors_precomp"), extra.get("cov3d_precomp"))
    want_s = tp.plain_preprocess(scene, camera, sm, None, colors, cov3d)
    for f in ("mean2d", "conic", "color", "opacity", "depth", "radius"):
        assert torch.equal(getattr(s, f), getattr(want_s, f)), f
    assert not s.depth.requires_grad and not s.radius.requires_grad
    assert _counts() == {"preprocess_forward": 1, "preprocess_backward": 0}

    # B2 hands the preprocess its gradients as column views of one [N, 9] array
    packed = torch.randn((scene.capacity, 9), generator=torch.Generator().manual_seed(5))
    up = [packed[:, 0:2], packed[:, 2:5], packed[:, 5:8], packed[:, 8]]
    loss = _PackedBlend.apply(packed, *(getattr(s, f) for f in SPLAT_GRADS))
    leaves = {k: v for k, v in {**params, **extra}.items() if v.requires_grad}
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)))
    assert _counts() == {"preprocess_forward": 1, "preprocess_backward": 1}
    symbol, args = fakes.calls[-1]
    assert symbol == "lg_preprocess_backward"
    asked = [p is not None for p in args[19:28]]
    used = {k for k in tp._GRADS if k in leaves}
    if colors is not None:
        used -= {"sh_dc", "sh_rest"}
    if cov3d is not None:
        used -= {"log_scales", "quats"}
    assert asked == [k in used for k in tp._GRADS]
    assert args[28 + 10:28 + 14] == (9, 9, 9, 9)  # the upstream gradients' row strides, read without a copy
    want = _autograd(scene, camera, [u.detach() for u in up], sm, offset, colors, cov3d)
    for k, g in got.items():
        if k in used:
            _hold(f"{name}: {k}", g, want[k])
        else:
            assert g is None, k


def test_autograd_node_forward_only_under_no_grad(fakes):
    scene, camera, *_ = _inputs("sh3", n=200)
    with torch.no_grad():
        s = _node(scene, camera)
    assert not s.mean2d.requires_grad
    assert _counts() == {"preprocess_forward": 1, "preprocess_backward": 0}
    assert [c[0] for c in fakes.calls] == ["lg_preprocess_forward"]


def test_autograd_node_with_one_output_differentiated(fakes):
    """Upstream gradients autograd does not give are passed as null pointers
    and read as zero."""
    scene, camera, *_ = _inputs("sh2_of_sh3", n=200)
    params = {k: v.clone().requires_grad_(True) for k, v in scene.params().items()}
    s = _node(scene.with_params(params), camera)
    g = torch.autograd.grad(s.color.sum(), [params["sh_dc"], params["means"]])
    _symbol, args = fakes.calls[-1]
    assert args[15] is None and args[16] is None and args[17] is not None and args[18] is None
    want = _autograd(scene, camera, [torch.zeros(200, 2), torch.zeros(200, 3), torch.ones(200, 3), torch.zeros(200)])
    _hold("sh_dc", g[0], want["sh_dc"])
    _hold("means", g[1], want["means"])


def test_preprocess_on_the_cpu_is_the_chain(fakes):
    scene, camera, sm, *_ = _inputs("stress_sh3")
    got, want = tp.preprocess(scene, camera, sm), tp.plain_preprocess(scene, camera, sm)
    for f in ("mean2d", "conic", "color", "opacity", "depth", "radius"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert _counts() == {"preprocess_forward": 0, "preprocess_backward": 0} and not fakes.calls


def _bad_inputs():
    n = 64
    return {
        "means float64": dict(scene=dict(means=torch.zeros(n, 3, dtype=torch.float64))),
        "means [N, 4]": dict(scene=dict(means=torch.zeros(n, 4))),
        "means strided columns": dict(scene=dict(means=torch.zeros(n, 6)[:, ::2])),
        "quats [N, 3]": dict(scene=dict(quats=torch.zeros(n, 3))),
        "log_scales [N+1, 3]": dict(scene=dict(log_scales=torch.zeros(n + 1, 3))),
        "opacity_logits [N, 1]": dict(scene=dict(opacity_logits=torch.zeros(n, 1))),
        "alive float32": dict(scene=dict(alive=torch.ones(n))),
        "sh_dc on another device": dict(scene=dict(sh_dc=torch.zeros(n, 3, device="meta"))),
        "sh_rest rows of [3, K]": dict(scene=dict(sh_rest=torch.zeros(n, 3, 15).transpose(1, 2))),
        "sh_rest too narrow for the degree": dict(scene=dict(sh_rest=torch.zeros(n, 8, 3))),
        "sh_rest wider than SH 4": dict(scene=dict(sh_rest=torch.zeros(n, 25, 3))),
        "SH degree 5": dict(scene=dict(active_sh_degree=5)),
        "SH degree -1": dict(scene=dict(active_sh_degree=-1)),
        "offset [N, 3]": dict(mean2d_offset=torch.zeros(n, 3)),
        "offset float16": dict(mean2d_offset=torch.zeros(n, 2, dtype=torch.float16)),
        "colors_precomp [N]": dict(colors_precomp=torch.zeros(n)),
        "cov3d_precomp [N, 3, 3]": dict(cov3d_precomp=torch.zeros(n, 3, 3)),
        "cov3d_precomp strided columns": dict(cov3d_precomp=torch.zeros(n, 12)[:, ::2]),
        "world_view transposed": dict(camera=dict(world_view=torch.eye(4)[:, [0, 2, 1, 3]].t())),
        "full_proj [3, 4]": dict(camera=dict(full_proj=torch.zeros(3, 4))),
        "tan_fovx [1]": dict(camera=dict(tan_fovx=torch.ones(1))),
        "camera_center float64": dict(camera=dict(camera_center=torch.zeros(3, dtype=torch.float64))),
        "camera on another device": dict(camera=dict(world_view=torch.eye(4, device="meta"))),
        "width 0": dict(camera=dict(width=0)),
        "all on a device of neither kind": "meta",
    }


BAD = _bad_inputs()


@pytest.mark.parametrize("case", sorted(BAD))
def test_preprocess_refuses_bad_inputs_before_any_launch(case, monkeypatch):
    def no_build(*_args):
        raise AssertionError("the preprocess kernels were built or launched")

    monkeypatch.setattr(cuda_build, "load", no_build)
    monkeypatch.setattr(cuda_build.Kernel, "_launch", no_build)
    # CPU tensors stand for CUDA ones: the kernel route, and its checks, take them
    on_card = cuda_build.on_card
    monkeypatch.setattr(cuda_build, "on_card", lambda t, what: t.device.type == "cpu" or on_card(t, what))
    scene = tsyn.random_scene(n=64, seed=2, device="cpu")
    camera = tsyn.default_camera(width=W, height=H, device="cpu")
    kwargs = {}
    bad = BAD[case]
    if bad == "meta":
        scene = dataclasses.replace(scene, **{f: getattr(scene, f).to("meta") for f in (*PARAMS, "alive")})
        camera = dataclasses.replace(camera, **{f: getattr(camera, f).to("meta") for f in tp._CAMERA})
    else:
        scene = dataclasses.replace(scene, **bad.get("scene", {}))
        camera = dataclasses.replace(camera, **bad.get("camera", {}))
        kwargs = {k: v for k, v in bad.items() if k not in ("scene", "camera")}
    cuda_build.reset_launch_counts()
    with pytest.raises(ValueError):
        tp.preprocess(scene, camera, **kwargs)
    assert _counts() == {"preprocess_forward": 0, "preprocess_backward": 0}


# layouts the kernels refuse and the chain takes: name -> (scene or camera, field, the field's tensor from its value)
CHAIN_LAYOUTS = {
    "means strided columns": ("scene", "means", lambda t: torch.stack([t, t], dim=-1).flatten(1)[:, ::2]),
    "sh_rest rows of [3, K]": ("scene", "sh_rest", lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)),
    "sh_rest wider than SH 4": ("scene", "sh_rest", lambda t: torch.cat([t, torch.ones(t.shape[0], 10, 3)], 1)),
    "world_view transposed": ("camera", "world_view", lambda t: t.t().contiguous().t()),
    "camera_center strided": ("camera", "camera_center", lambda t: torch.stack([t, t], dim=-1).flatten()[::2]),
}


@pytest.mark.parametrize("case", sorted(CHAIN_LAYOUTS))
def test_preprocess_on_the_cpu_takes_what_the_chain_takes(case, fakes):
    """The kernels' layout rules do not narrow the CPU path: it runs the
    chain on any layout, as on the same values laid out contiguously."""
    part, field, lay_out = CHAIN_LAYOUTS[case]
    inputs = {"scene": tsyn.random_scene(n=64, seed=3, device="cpu"),
              "camera": tsyn.default_camera(width=W, height=H, device="cpu")}
    odd = lay_out(getattr(inputs[part], field))
    assert not odd.is_contiguous() or odd.shape[1] > tp.MAX_SH_REST
    scene_odd, cam_odd = ({**inputs, part: dataclasses.replace(inputs[part], **{field: odd})}[p]
                          for p in ("scene", "camera"))
    scene_plain, cam_plain = ({**inputs, part: dataclasses.replace(inputs[part], **{field: odd.contiguous()})}[p]
                              for p in ("scene", "camera"))
    got, want = tp.preprocess(scene_odd, cam_odd), tp.plain_preprocess(scene_plain, cam_plain)
    for f in ("mean2d", "conic", "color", "opacity", "depth", "radius"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert _counts() == {"preprocess_forward": 0, "preprocess_backward": 0} and not fakes.calls
