"""Live-viewer TCP protocol (SIBR remote viewer compatible).

Port of `lightgaussian_tpu/render/network_gui.py`, wire-compatible byte for
byte: a non-blocking TCP listener; inbound messages are 4-byte
little-endian length-prefixed JSON carrying resolution, FoVs, near/far,
training toggles, a scaling modifier, and row-major *transposed* view and
view-projection matrices (columns 1 and 2 sign-flipped on receipt);
outbound is the raw HxWx3 uint8 render followed by a length-prefixed verify
string.

What differs from the JAX package, on purpose: its `poll` swallows every
exception and drops the connection, which would hide a failed render (a
kernel launch inside `render_fn`). Here `poll` drops the connection only on
the socket's and the message's errors (`PROTOCOL_ERRORS`: a closed or
broken socket, a malformed length or JSON, a missing field); an error of
`render_fn` propagates.

State lives in a `NetworkGUI` object; the module-level `init`,
`try_connect`, `receive`, `send`, `poll` and `close` wrap a default
instance, as the reference's global API does.
"""
from __future__ import annotations

import json
import math
import socket

import numpy as np
import torch

from lightgaussian_tpu_torch.models.camera import Camera
from lightgaussian_tpu_torch.utils.device import resolve_device

# What a viewer connection can raise: socket errors (ConnectionError is
# one), undecodable or malformed JSON (ValueError), a missing field
# (KeyError) or a field of the wrong type (TypeError).
PROTOCOL_ERRORS = (OSError, ValueError, KeyError, TypeError)


def camera_from_message(message: dict, device: str | torch.device = "cuda") -> Camera | None:
    """A render Camera from a viewer message; None at zero resolution.

    The viewer sends the reference's transposed-layout matrices; flipping
    their columns 1 and 2 and transposing gives the column-vector
    world-to-camera and world-to-clip matrices."""
    width = int(message["resolution_x"])
    height = int(message["resolution_y"])
    if width == 0 or height == 0:
        return None
    dev = resolve_device(device)
    wvt = np.array(message["view_matrix"], np.float32).reshape(4, 4)
    wvt[:, 1] *= -1
    wvt[:, 2] *= -1
    fpt = np.array(message["view_projection_matrix"], np.float32).reshape(4, 4)
    fpt[:, 1] *= -1
    fpt[:, 2] *= -1
    world_view = np.ascontiguousarray(wvt.T)
    full_proj = np.ascontiguousarray(fpt.T)
    cam_center = np.linalg.inv(world_view)[:3, 3].astype(np.float32)
    return Camera(
        world_view=torch.from_numpy(world_view).to(dev),
        full_proj=torch.from_numpy(full_proj).to(dev),
        camera_center=torch.from_numpy(cam_center).to(dev),
        tan_fovx=torch.tensor(np.float32(math.tan(float(message["fov_x"]) / 2.0)), device=dev),
        tan_fovy=torch.tensor(np.float32(math.tan(float(message["fov_y"]) / 2.0)), device=dev),
        width=width,
        height=height,
    )


def image_to_bytes(img: torch.Tensor) -> bytes:
    """[3, H, W] float render -> the viewer's HxWx3 uint8 byte stream."""
    arr = torch.clamp(img.detach(), 0.0, 1.0).cpu().numpy()
    return np.ascontiguousarray((arr * 255.0).astype(np.uint8).transpose(1, 2, 0)).tobytes()


class NetworkGUI:
    """One viewer listener and its connection. Cameras are built on
    `device` (default cuda; resolved when the first one is built)."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = device
        self.listener: socket.socket | None = None
        self.conn: socket.socket | None = None
        self.addr = None

    def init(self, host: str, port: int) -> None:
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)

    def try_connect(self) -> None:
        if self.listener is None:
            return
        try:
            self.conn, self.addr = self.listener.accept()
            print(f"\nConnected by {self.addr}")
            self.conn.settimeout(None)
        except OSError:
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def read(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def send(self, image_bytes: bytes | None, verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self):
        """-> (camera|None, do_training, shs_python, rot_scale_python,
        keep_alive, scaling_modifier), the reference's tuple; all None at
        zero resolution."""
        message = self.read()
        cam = camera_from_message(message, self.device)
        if cam is None:
            return None, None, None, None, None, None
        return (
            cam,
            bool(message["train"]),
            bool(message["shs_python"]),
            bool(message["rot_scale_python"]),
            bool(message["keep_alive"]),
            float(message["scaling_modifier"]),
        )

    def _drop(self) -> None:
        conn, self.conn = self.conn, None
        try:
            conn.close()
        except OSError:
            pass

    def poll(self, render_fn, source_path: str, training_done: bool) -> None:
        """One training iteration's viewer service: accept a pending
        connection, then answer view requests (`render_fn(camera,
        scaling_modifier)` -> [3, H, W]) until the viewer lets training go
        on. A protocol error drops the connection; an error of `render_fn`
        propagates."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, do_training, _, _, keep_alive, scale_mod = self.receive()
            except PROTOCOL_ERRORS:
                self._drop()
                break
            image_bytes = None if cam is None else image_to_bytes(render_fn(cam, scale_mod))
            try:
                self.send(image_bytes, source_path)
            except PROTOCOL_ERRORS:
                self._drop()
                break
            if do_training and (not training_done or not keep_alive):
                break

    def close(self) -> None:
        for s in (self.conn, self.listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self.conn = self.listener = None


# The module-level instance behind the reference's global API.
_default = NetworkGUI()
init = _default.init
try_connect = _default.try_connect
receive = _default.receive
send = _default.send
poll = _default.poll
close = _default.close


def conn():
    return _default.conn
