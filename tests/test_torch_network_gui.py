"""PyTorch port vs the JAX package: the live viewer's protocol
(`render/network_gui.py`).

A fake SIBR viewer connects over a real localhost socket, sends the
reference's length-prefixed JSON (transposed matrices with columns 1 and 2
negated) and reads back the raw HxWx3 frame and the length-prefixed verify
string. Held:
- `camera_from_message` against the JAX package's on the same message:
  world_view 1e-5, full_proj and the centre 1e-4 (the JAX suite's
  tolerances against the camera the message was made from);
- `image_to_bytes` byte for byte against the JAX package's on one image;
- a frame served by `poll` equal to `image_to_bytes` of the port's render,
  and the verify string;
- zero resolution: no frame, the all-None tuple;
- the deliberate difference: an error of `render_fn` propagates out of
  `poll` (the JAX `poll` drops the connection and carries on), while a
  malformed message only drops the connection.
"""
import json
import math
import socket
import threading

import numpy as np
import pytest
import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.ops.rasterize import render
from lightgaussian_tpu_torch.render import network_gui
from lightgaussian_tpu_torch.utils.synthetic import random_scene

torch.set_num_threads(1)
MAXI = 1 << 16


def _viewer_message(cam: Camera, train=True, keep_alive=False, scale=1.0) -> dict:
    wvt = cam.world_view.numpy().T.copy()
    wvt[:, 1] *= -1
    wvt[:, 2] *= -1
    fpt = cam.full_proj.numpy().T.copy()
    fpt[:, 1] *= -1
    fpt[:, 2] *= -1
    return {
        "resolution_x": cam.width, "resolution_y": cam.height, "train": train,
        "fov_y": 2.0 * math.atan(float(cam.tan_fovy)), "fov_x": 2.0 * math.atan(float(cam.tan_fovx)),
        "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": keep_alive, "scaling_modifier": scale,
        "view_matrix": wvt.reshape(-1).tolist(), "view_projection_matrix": fpt.reshape(-1).tolist(),
    }


def _send_raw(sock: socket.socket, raw: bytes) -> None:
    sock.sendall(len(raw).to_bytes(4, "little") + raw)


def _send_msg(sock: socket.socket, payload: dict) -> None:
    _send_raw(sock, json.dumps(payload).encode("utf-8"))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed early"
        buf += chunk
    return buf


def _listener():
    gui = network_gui.NetworkGUI(device="cpu")
    gui.init("127.0.0.1", 0)  # an ephemeral port
    return gui, gui.listener.getsockname()[1]


def _camera():
    return Camera.look_at((1.0, 0.5, 2.0), (0, 0, 0), fovx=0.9, width=48, height=32, device="cpu")


def test_camera_from_message_matches_jax():
    from lightgaussian_tpu.render import network_gui as jgui

    cam = _camera()
    msg = _viewer_message(cam)
    got = network_gui.camera_from_message(msg, device="cpu")
    want = jgui.camera_from_message(msg)
    assert (got.width, got.height) == (want.width, want.height) == (48, 32)
    np.testing.assert_allclose(got.world_view.numpy(), np.asarray(want.world_view), atol=1e-5)
    np.testing.assert_allclose(got.full_proj.numpy(), np.asarray(want.full_proj), atol=1e-4)
    np.testing.assert_allclose(got.camera_center.numpy(), np.asarray(want.camera_center), atol=1e-4)
    np.testing.assert_allclose(got.tan_fovx.numpy(), np.asarray(want.tan_fovx), rtol=1e-6)
    np.testing.assert_allclose(got.tan_fovy.numpy(), np.asarray(want.tan_fovy), rtol=1e-6)
    # and the camera the message came from
    np.testing.assert_allclose(got.world_view.numpy(), cam.world_view.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.full_proj.numpy(), cam.full_proj.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.camera_center.numpy(), cam.camera_center.numpy(), atol=1e-4)


def test_image_to_bytes_matches_jax():
    import jax.numpy as jnp

    from lightgaussian_tpu.render import network_gui as jgui

    img = np.random.default_rng(0).uniform(-0.2, 1.2, (3, 5, 7)).astype(np.float32)
    got = network_gui.image_to_bytes(torch.from_numpy(img))
    assert got == jgui.image_to_bytes(jnp.asarray(img))
    assert len(got) == 5 * 7 * 3


def test_gui_serves_frame_over_socket():
    scene = random_scene(n=80, seed=0, extent=0.8, scale_range=(0.04, 0.1), device="cpu")
    bg = torch.zeros(3)
    cam = Camera.look_at((2.0, 0.4, 1.5), (0, 0, 0), fovx=0.9, width=40, height=30, device="cpu")
    seen = []

    def render_fn(c, scale_mod):
        seen.append(scale_mod)
        return render(scene, c, bg, scale_modifier=scale_mod, max_instances=MAXI, fast=True).render

    gui, port = _listener()
    server = threading.Thread(target=lambda: gui.poll(render_fn, "/data/scene", training_done=False))
    client = socket.create_connection(("127.0.0.1", port), timeout=30)
    server.start()
    try:
        # one request at half scale that keeps the viewer's turn, then one that lets training go on
        for scale, train in ((0.5, False), (1.0, True)):
            _send_msg(client, _viewer_message(cam, train=train, scale=scale))
            img = _recv_exact(client, cam.width * cam.height * 3)
            n = int.from_bytes(_recv_exact(client, 4), "little")
            assert _recv_exact(client, n).decode("ascii") == "/data/scene"
            want = render(scene, network_gui.camera_from_message(_viewer_message(cam), device="cpu"), bg,
                          scale_modifier=scale, max_instances=MAXI, fast=True).render
            assert img == network_gui.image_to_bytes(want)
    finally:
        server.join(timeout=60)
        client.close()
        gui.close()
    assert not server.is_alive()
    assert seen == [0.5, 1.0]


def test_zero_resolution_means_no_frame():
    gui, port = _listener()
    client = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        gui.try_connect()
        assert gui.conn is not None
        msg = _viewer_message(_camera())
        msg["resolution_x"] = 0
        _send_msg(client, msg)
        assert gui.receive() == (None,) * 6
    finally:
        client.close()
        gui.close()


def test_poll_raises_what_render_fn_raises():
    gui, port = _listener()
    client = socket.create_connection(("127.0.0.1", port), timeout=10)

    def render_fn(c, scale_mod):
        raise RuntimeError("a kernel launch failed")

    try:
        _send_msg(client, _viewer_message(_camera()))
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            gui.poll(render_fn, "/data/scene", training_done=False)
    finally:
        client.close()
        gui.close()


def test_poll_drops_a_malformed_message():
    gui, port = _listener()
    client = socket.create_connection(("127.0.0.1", port), timeout=10)

    def render_fn(c, scale_mod):
        raise AssertionError("no frame is asked for")

    try:
        _send_raw(client, b"{not json")
        gui.poll(render_fn, "/data/scene", training_done=False)
        assert gui.conn is None
        # a fresh connection is served again
        client2 = socket.create_connection(("127.0.0.1", port), timeout=10)
        msg = _viewer_message(_camera())
        del msg["train"]
        _send_msg(client2, msg)
        gui.poll(render_fn, "/data/scene", training_done=False)
        assert gui.conn is None
        client2.close()
    finally:
        client.close()
        gui.close()
