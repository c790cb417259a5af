"""Crash-safe PNG output.

Equivalent of the reference's PNG export (src/main.rs:764-776):
encode RGB8, write to a temp file next to the target, then atomically rename
so a killed progressive render always leaves a valid image on disk.

The fast path is the C++ host runtime (native/), loaded via ctypes; this
module is the pure-Python fallback and the reference implementation the
native library is tested against.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png_rgb8(rgb: np.ndarray) -> bytes:
    """Encode an [H, W, 3] uint8 array as a PNG byte string (color type 2)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    # Filter byte 0 (None) prepended to every scanline.
    raw = np.empty((h, 1 + w * 3), dtype=np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = rgb.reshape(h, w * 3)
    compressed = zlib.compress(raw.tobytes(), 6)
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            _chunk(b"IHDR", header),
            _chunk(b"IDAT", compressed),
            _chunk(b"IEND", b""),
        ]
    )


def decode_png_rgb8(data: bytes) -> np.ndarray:
    """Minimal PNG decoder for round-trip tests (filter types 0-4, RGB8)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            assert depth == 8 and ctype == 2, "only RGB8 supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), dtype=np.uint8)
    stride = 1 + w * 3
    raw = raw.reshape(h, stride)
    out = np.zeros((h, w * 3), dtype=np.uint8)
    for y in range(h):
        ftype = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        prev = out[y - 1].astype(np.int32) if y > 0 else np.zeros(w * 3, np.int32)
        if ftype == 0:
            out[y] = line
        elif ftype == 2:
            out[y] = (line + prev) & 0xFF
        else:
            cur = np.zeros(w * 3, dtype=np.int32)
            for i in range(w * 3):
                a = cur[i - 3] if i >= 3 else 0
                b = prev[i]
                c = prev[i - 3] if i >= 3 else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:  # 4 Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
            out[y] = cur
    return out.reshape(h, w, 3)


def write_png_atomic(path: str, rgb: np.ndarray) -> None:
    """Write [H, W, 3] uint8 to `path` via tmp-file + atomic rename.

    Mirrors the reference's ./tmp.png + rename dance (src/main.rs:764-776)
    but keeps the temp file in the destination directory so the rename is
    atomic on any filesystem.
    """
    from raytracer_tpu.utils import native

    if native.available():
        native.write_png_atomic(path, rgb)
        return
    data = encode_png_rgb8(rgb)
    directory = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(directory, f".{os.path.basename(path)}.tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_png_rgb8(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png_rgb8(f.read())
