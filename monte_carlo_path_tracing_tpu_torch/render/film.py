"""Tone mapping and image output (BMP, PNG, NPY).

Counterpart of ``monte_carlo_path_tracing_tpu/render/film.py``: the
framebuffer is an [H, W, 3] f32 numpy array; BMP is the reference's 24bpp
bottom-up format, PNG is written with zlib alone.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from monte_carlo_path_tracing_tpu_torch.core.radiometry import tone_map


def to_srgb_u8(hdr: np.ndarray, max_radiance: float, gamma: float) -> np.ndarray:
    """[H,W,3] f32 radiance -> [H,W,3] u8 via the reference tone map."""
    return tone_map(torch.as_tensor(np.asarray(hdr, np.float32)),
                    max_radiance, gamma).numpy()


def write_bmp(path: str, img_u8: np.ndarray) -> None:
    """24bpp uncompressed BMP, bottom-up, BGR (the reference's test.bmp)."""
    h, w, _ = img_u8.shape
    row_stride = (w * 3 + 3) & ~3
    img_size = row_stride * h
    header = struct.pack(
        "<2sIHHI", b"BM", 14 + 40 + img_size, 0, 0, 14 + 40
    ) + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, img_size, 2835, 2835, 0, 0)
    pad = b"\x00" * (row_stride - w * 3)
    bgr = img_u8[:, :, ::-1]
    rows = [bgr[y].tobytes() + pad for y in range(h - 1, -1, -1)]
    with open(path, "wb") as f:
        f.write(header + b"".join(rows))


def write_png(path: str, img_u8: np.ndarray) -> None:
    h, w, _ = img_u8.shape
    raw = b"".join(b"\x00" + img_u8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def write_image(path: str, hdr: np.ndarray, max_radiance: float, gamma: float) -> None:
    """Write ``hdr`` by extension: .bmp / .png tone-mapped, .npy raw."""
    lower = path.lower()
    if lower.endswith(".npy"):
        np.save(path, hdr)
        return
    img = to_srgb_u8(hdr, max_radiance, gamma)
    if lower.endswith(".bmp"):
        write_bmp(path, img)
    elif lower.endswith(".png"):
        write_png(path, img)
    else:
        raise ValueError(f"unsupported image extension: {path}")
