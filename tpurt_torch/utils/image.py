"""Image output: PNG (stdlib zlib), PFM and PPM writers, and a PFM reader
(``tpurt.utils.image``, NumPy, the same bytes).

Every writer also takes a torch tensor on any device: it is copied to the
host first (``np.asarray`` raises on a CUDA tensor).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _host(img) -> np.ndarray:
    """``img`` as a NumPy array; a torch tensor is copied to the host."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img)


def to_srgb8(img_linear) -> np.ndarray:
    """Linear [0,1] float -> sRGB-encoded uint8."""
    x = np.clip(np.asarray(_host(img_linear), np.float32), 0.0, 1.0)
    srgb = np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1.0 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).astype(np.uint8)


def png_bytes(img, assume_srgb8: bool = False) -> bytes:
    """Encode an (H, W, 3) image as PNG bytes. Float input is treated as
    linear RGB and sRGB-encoded; uint8 input is encoded as-is."""
    img = _host(img)
    if img.dtype != np.uint8:
        img = to_srgb8(img)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)

    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))
    compressed = zlib.compress(raw, 6)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", compressed) + chunk(b"IEND", b""))


def write_png(path: str, img, assume_srgb8: bool = False) -> None:
    """Write an (H, W, 3) image to PNG (see png_bytes)."""
    with open(path, "wb") as f:
        f.write(png_bytes(img, assume_srgb8))


def write_pfm(path: str, img) -> None:
    """Write (H, W, 3) float32 linear radiance to PFM (rows bottom to top,
    negative scale: little-endian)."""
    img = np.asarray(_host(img), np.float32)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_pfm needs (H, W, 3) or (H, W), got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"PF\n{w} {h}\n-1.0\n".encode())
        f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM written by write_pfm back to (H, W, 3) float32."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"PF":
            raise ValueError(f"{path}: only 3-channel PF is supported")
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3)[::-1].astype(np.float32)
    if abs(scale) != 1.0:  # spec: |scale| multiplies the stored samples
        img = img * np.float32(abs(scale))
    return img


def write_ppm(path: str, img) -> None:
    """Write an (H, W, 3) image to binary PPM (P6)."""
    img = _host(img)
    if img.dtype != np.uint8:
        img = to_srgb8(img)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())
