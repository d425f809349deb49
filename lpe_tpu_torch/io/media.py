"""Frame export: PNG / GIF / MP4.

The counterpart of ``lpe_tpu/io/media.py``. ``save_png`` writes an 8-bit
RGB PNG with the standard library alone (zlib, struct, crc32; filter 0 on
each row), the image lpe_tpu's PIL call writes, so the port needs no PIL
for its frames. ``save_gif`` needs PIL and ``save_mp4`` imageio, as in
lpe_tpu; where the package is missing they fail naming it.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + \
        struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def save_png(path: str, frame) -> None:
    """Write ``frame`` (uint8 [H, W, 3]) as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(np.asarray(frame), dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] frame, got {img.shape}")
    H, W, _ = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           img.reshape(H, W * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def save_gif(path: str, frames, fps: int = 30) -> None:
    from PIL import Image
    if not frames:
        raise ValueError("no frames to save")
    imgs = [Image.fromarray(np.asarray(f)) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(1, int(1000 / fps)), loop=0)


def save_mp4(path: str, frames, fps: int = 30) -> None:
    try:
        import imageio.v2 as imageio
    except ImportError as e:  # pragma: no cover - optional dependency
        raise RuntimeError("mp4 export needs imageio; use save_gif") from e
    imageio.mimwrite(path, [np.asarray(f) for f in frames], fps=fps)
