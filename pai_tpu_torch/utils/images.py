"""Image-space helpers: denormalise, uint8 conversion, the afmhot colormap and
PNG reading/writing, counterpart of ``pai_tpu/utils/images.py``.

The JAX package leans on matplotlib (colormap) and PIL (PNG fallback); the
port must run where neither is installed, so it carries its own:

* ``afmhot_lut`` computes matplotlib's ``afmhot`` from its piecewise-linear
  definition (r: 0->1 over [0, .5]; g: 0->1 over [.25, .75]; b: 0->1 over
  [.5, 1]) at the 256 LUT positions;
* ``read_png_gray`` / ``write_png`` go through the native C++ codec
  (``pai_tpu_torch/native``), as the JAX package's do where it is built;
* ``read_png`` / ``read_png_gray_plain`` / ``write_png_plain`` are the plain
  version of that codec on ``zlib`` + numpy, for the tests and the GPU smoke
  test to hold it against: the same PNG subset (8- and 16-bit non-interlaced
  gray, gray+alpha, RGB, RGBA and 8-bit palette images; all five filter
  types; the high byte of a 16-bit sample), the same float luma, the same
  file written. Filter types 3 and 4 (Average, Paeth) are undone pixel by
  pixel in Python, which is slow for large files.
"""

from __future__ import annotations

import struct
import zlib
from typing import Union

import numpy as np
import torch

from pai_tpu_torch.native import png_native

_UINT8_SCALE = 255.0 + 1.0 - 1e-3  # torchvision convert_image_dtype epsilon
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples/pixel
# ITU-R 601-2 luma as the codec's to_gray computes it, in float32
_LUMA = tuple(np.float32(c) for c in (0.299, 0.587, 0.114))


def denormalize(x: torch.Tensor) -> torch.Tensor:
    """clamp(x * 0.5 + 0.5, 0, 1)."""
    return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)


def to_int(x: Union[torch.Tensor, np.ndarray]):
    """float [0,1] -> uint8 with torchvision's truncation: scale by
    ``255 + 1 - 1e-3`` and floor. Tensors stay tensors, arrays arrays."""
    if isinstance(x, torch.Tensor):
        return torch.clamp(torch.floor(x.float() * _UINT8_SCALE), 0, 255
                           ).to(torch.uint8)
    return np.clip(np.floor(np.asarray(x, np.float32) * _UINT8_SCALE), 0, 255
                   ).astype(np.uint8)


_AFMHOT_LUT = None


def afmhot_lut() -> np.ndarray:
    """256x3 float32 LUT of matplotlib's afmhot colormap (read-only)."""
    global _AFMHOT_LUT
    if _AFMHOT_LUT is None:
        x = np.linspace(0.0, 1.0, 256)
        lut = np.stack([np.clip(2.0 * x, 0.0, 1.0),
                        np.clip(2.0 * x - 0.5, 0.0, 1.0),
                        np.clip(2.0 * x - 1.0, 0.0, 1.0)], axis=1)
        lut = lut.astype(np.float32)
        lut.setflags(write=False)
        _AFMHOT_LUT = lut
    return _AFMHOT_LUT


def afmhot_rgb(img: np.ndarray) -> np.ndarray:
    """Grayscale [H,W] float in [0,1] -> RGB float [H,W,3] via afmhot:
    matplotlib quantises to its 256 LUT entries as index = floor(x * 256)
    clipped to [0, 255]."""
    idx = np.clip((np.asarray(img) * 256.0).astype(np.int32), 0, 255)
    return afmhot_lut()[idx]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_array(array: np.ndarray) -> np.ndarray:
    """``array`` as a [H,W] or [H,W,3] uint8 array; raises on anything
    else."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        raise TypeError(f"write_png expects uint8, got {arr.dtype}")
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] == 3)):
        raise ValueError(f"write_png expects [H,W] or [H,W,3], got {arr.shape}")
    return arr


def write_png(array: np.ndarray, path: str, compress_level: int = 0) -> None:
    """Write a [H,W], [H,W,1] or [H,W,3] uint8 array as an 8-bit gray / RGB
    PNG through the native codec, filter 0 on every row. The reference writes
    with compression level 0, the default here."""
    png_native.write_png(_png_array(array), path, compress_level)


def write_png_plain(array: np.ndarray, path: str,
                    compress_level: int = 0) -> None:
    """The plain version of ``write_png``: the same file, written with
    Python's ``zlib``."""
    arr = _png_array(array)
    colour_type = 0 if arr.ndim == 2 else 2
    h, w = arr.shape[:2]
    rows = np.zeros((h, 1 + arr[0].size), np.uint8)  # leading filter byte 0
    rows[:, 1:] = arr.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(),
                                                compress_level))
                + _chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters. raw: (h, 1 + stride) uint8."""
    out = np.zeros((h, stride), np.uint8)
    zero_row = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = int(raw[y, 0])
        line = raw[y, 1:]
        prior = out[y - 1] if y else zero_row
        if ftype == 0:
            out[y] = line
        elif ftype == 1:  # Sub: running sum per sample lane, mod 256
            lanes = line.reshape(-1, bpp).astype(np.uint32)
            out[y] = (np.cumsum(lanes, axis=0) & 0xFF).astype(
                np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            out[y] = line + prior  # uint8 wraps mod 256
        elif ftype in (3, 4):
            cur = bytearray(stride)
            src = line.tolist()
            up = prior.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:  # Average
                    pred = (a + b) >> 1
                else:  # Paeth
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (src[i] + pred) & 0xFF
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype} does not exist")
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG in the plain version -> uint8 [H,W] (gray) or [H,W,C] (C
    = 2 gray+alpha, 3 RGB or palette, 4 RGBA); a 16-bit sample keeps its
    high byte. Raises ``ValueError`` on what the native codec refuses too
    (sub-byte depths, 16-bit palette, Adam7)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    header = None
    idat, palette = [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour_type, _, _, interlace = header
    if depth not in (8, 16) or colour_type not in _CHANNELS \
            or interlace != 0 or (colour_type == 3 and depth != 8):
        raise ValueError(
            f"{path}: only 8- and 16-bit non-interlaced gray, RGB, palette "
            f"(8-bit) and gray/RGB+alpha PNGs are read (bit depth {depth}, "
            f"colour type {colour_type}, interlace {interlace})")
    channels = _CHANNELS[colour_type]
    bpp = channels * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG data has the wrong length")
    pixels = _unfilter(raw.reshape(h, stride + 1), h, stride, bpp)
    if depth == 16:
        pixels = pixels[:, 0::2]  # the high byte of each sample
    if colour_type == 3:
        if palette is None or int(pixels.max(initial=0)) * 3 + 2 \
                >= palette.size:
            raise ValueError(f"{path}: palette index outside PLTE")
        return palette.reshape(-1, 3)[pixels.reshape(h, w)]
    return pixels.reshape(h, w) if channels == 1 \
        else pixels.reshape(h, w, channels)


def read_png_gray(path: str) -> np.ndarray:
    """Read a PNG through the native codec as single-channel uint8 [H,W]:
    alpha is dropped; RGB and palette colours go through the ITU-R 601-2
    luma transform with float coefficients, ``uint8(0.299 R + 0.587 G +
    0.114 B + 0.5)`` in float32 (torchvision's ``ImageReadMode.GRAY``; PIL's
    fixed-point form can differ by one grey level)."""
    return png_native.read_png_gray(path)


def read_png_gray_plain(path: str) -> np.ndarray:
    """The plain version of ``read_png_gray``, byte for byte."""
    img = read_png(path)
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:
        return np.ascontiguousarray(img[..., 0])
    r, g, b = (img[..., k].astype(np.float32) for k in range(3))
    luma = _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b + np.float32(0.5)
    return luma.astype(np.uint8)
