"""Image files without a dependency: 8-bit PNG read and write in numpy + zlib.

The JAX package reads and writes images with PIL; the port does the common
case itself so that it runs where PIL is absent. Written: 8-bit gray, RGB or
RGBA PNG (filter type 0). Read: 8-bit non-interlaced gray, gray+alpha, RGB or
RGBA PNG with any of the five filter types. Any other file goes to PIL,
imported inside the call; without PIL that raises a clear error.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG color type -> channels


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def write_png(path: str | Path, arr: np.ndarray) -> None:
    """Write a uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] array as PNG."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 on every row
    raw[:, 1:] = arr.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(
        _SIGNATURE + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b"")
    )


def _png_header(data: bytes):
    """(width, height, bit_depth, color_type, interlace) of a PNG, or None."""
    if data[:8] != _SIGNATURE or data[12:16] != b"IHDR":
        return None
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    return w, h, depth, ctype, interlace


def _paeth_row(row: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def _avg_row(row: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((a + prev[i]) >> 1)) & 0xFF


def _decode_png(data: bytes, w: int, h: int, channels: int) -> np.ndarray:
    idat = b""
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        elif kind == b"IEND":
            break
        pos += 12 + length
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, stride + 1)
    filters = raw[:, 0]
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    bpp = channels
    for y in range(h):
        line = raw[y, 1:]
        f = int(filters[y])
        if f == 0:
            cur = line.copy()
        elif f == 1:  # Sub: running sum along the row, per byte of a pixel
            cur = np.cumsum(line.reshape(w, bpp).astype(np.int64), axis=0).astype(np.uint8).reshape(-1)
        elif f == 2:  # Up
            cur = line + prev
        elif f == 3:  # Average
            row = bytearray(line.tobytes())
            _avg_row(row, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(row), np.uint8)
        elif f == 4:  # Paeth
            row = bytearray(line.tobytes())
            _paeth_row(row, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {f}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, channels)


def _pil():
    try:
        from PIL import Image
    except ImportError as err:
        raise RuntimeError(
            "this image is not an 8-bit non-interlaced PNG, and reading or "
            "resizing it needs Pillow, which is not installed"
        ) from err
    return Image


def image_size(path: str | Path) -> tuple[int, int]:
    """(width, height) of an image file."""
    with open(path, "rb") as f:
        head = f.read(29)
    hdr = _png_header(head)
    if hdr is not None:
        return hdr[0], hdr[1]
    with _pil().open(path) as img:
        return img.size


def read_image(path: str | Path) -> np.ndarray:
    """uint8 [H, W, C] (C in 1..4) of an image file."""
    data = Path(path).read_bytes()
    hdr = _png_header(data)
    if hdr is not None:
        w, h, depth, ctype, interlace = hdr
        if depth == 8 and interlace == 0 and ctype in _CHANNELS:
            return _decode_png(data, w, h, _CHANNELS[ctype])
    with _pil().open(path) as img:
        arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise ValueError(f"{path}: only 8-bit images are supported, got {arr.dtype}")
    return arr[:, :, None] if arr.ndim == 2 else arr


def resize(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, C] resized as the JAX package resizes (PIL's default
    filter); returned unchanged when the size already matches."""
    if arr.shape[1] == width and arr.shape[0] == height:
        return arr
    image = _pil()
    squeeze = arr.shape[2] == 1
    img = image.fromarray(arr[:, :, 0] if squeeze else arr)
    out = np.asarray(img.resize((width, height)))
    return out[:, :, None] if squeeze else out
