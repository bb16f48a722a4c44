"""``ctypes`` bindings of the native PNG codec, resize and batch decoder,
counterpart of ``pai_tpu/native/png_native.py`` (the same four functions and
signatures). The library is built at the first call, not at import
(``pai_tpu_torch.native.load_library``); a failure to decode raises
``ValueError`` with the codec's reason."""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from pai_tpu_torch import native

# the codec's Status codes (png_codec.cc)
DECODE_ERRORS = {
    1: "cannot be read",
    2: "not a PNG file",
    3: "unsupported PNG (only 8- and 16-bit non-interlaced gray, RGB, "
       "palette, gray+alpha and RGBA images are read)",
    4: "corrupt PNG data",
    5: "out of memory",
}

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib() -> ctypes.CDLL:
    lib = native.load_library()
    if not getattr(lib, "_pai_declared", False):
        i32 = ctypes.c_int
        lib.pai_read_png_gray.restype = i32
        lib.pai_read_png_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_U8P), ctypes.POINTER(i32),
            ctypes.POINTER(i32)]
        lib.pai_free.restype = None
        lib.pai_free.argtypes = [ctypes.c_void_p]
        lib.pai_write_png.restype = i32
        lib.pai_write_png.argtypes = [ctypes.c_char_p, _U8P, i32, i32, i32,
                                      i32]
        lib.pai_resize_aa.restype = i32
        lib.pai_resize_aa.argtypes = [
            _U8P, i32, i32, ctypes.POINTER(ctypes.c_float), i32, i32]
        lib.pai_decode_batch_u8.restype = i32
        lib.pai_decode_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), i32, i32, _U8P, _U8P, i32]
        lib._pai_declared = True
    return lib


def decode_error(path: str, code: int) -> ValueError:
    return ValueError(f"{path}: {DECODE_ERRORS.get(code, 'decode failed')} "
                      f"(native PNG decoder, code {code})")


def read_png_gray(path: str) -> np.ndarray:
    """Decode a PNG as single-channel uint8 [H,W]: alpha dropped, RGB and
    palette colours through ITU-R 601-2 luma with float coefficients, 16-bit
    samples cut to their high byte."""
    lib = _lib()
    out = _U8P()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.pai_read_png_gray(path.encode(), ctypes.byref(out),
                               ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise decode_error(path, -rc)
    try:
        return np.ctypeslib.as_array(out, shape=(h.value, w.value)).copy()
    finally:
        lib.pai_free(out)


def write_png(array: np.ndarray, path: str, compress_level: int = 0) -> None:
    """Write a uint8 [H,W], [H,W,1] or [H,W,3] array as an 8-bit gray or RGB
    PNG, filter 0 on every row, zlib level ``compress_level``."""
    arr = np.ascontiguousarray(array, dtype=np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = np.ascontiguousarray(arr[..., 0])
    if arr.ndim == 2:
        channels = 1
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        channels = 3
    else:
        raise ValueError(f"unsupported PNG shape {arr.shape}")
    rc = _lib().pai_write_png(path.encode(), arr.ctypes.data_as(_U8P),
                              arr.shape[0], arr.shape[1], channels,
                              compress_level)
    if rc != 0:
        raise OSError(f"native PNG write failed ({rc}): {path}")


def resize_bilinear_antialias(img: np.ndarray, dh: int, dw: int
                              ) -> np.ndarray:
    """uint8 [H,W] -> float32 [dh,dw] on the [0, 255] scale, triangle filter
    (torchvision ``Resize(antialias=True)``)."""
    src = np.ascontiguousarray(img, dtype=np.uint8)
    if src.ndim != 2 or min(src.shape) < 1 or dh < 1 or dw < 1:
        raise ValueError(f"resize of a {src.shape} image to ({dh}, {dw})")
    dst = np.empty((dh, dw), np.float32)
    rc = _lib().pai_resize_aa(src.ctypes.data_as(_U8P), src.shape[0],
                              src.shape[1],
                              dst.ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_float)), dh, dw)
    if rc != 0:
        raise ValueError("native resize failed")
    # the codec resizes to [0, 1]; callers take the [0, 255] float scale
    return dst * 255.0


def decode_batch_u8(paths: Sequence[str], size: int, num_threads: int = 8
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode ``paths`` on ``num_threads`` threads into ``([N, size, size,
    1] uint8, failed [N] uint8)``: a file of another size is resized
    (antialiased) and rounded back to uint8, torchvision's uint8 ``Resize``.
    ``failed[i]`` is 0 or the codec's reason code (``DECODE_ERRORS``); a
    failed row is left zero."""
    if size < 1:
        raise ValueError(f"decode size {size}")
    n = len(paths)
    out = np.zeros((n, size, size), np.uint8)
    failed = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    _lib().pai_decode_batch_u8(arr, n, size, out.ctypes.data_as(_U8P),
                               failed.ctypes.data_as(_U8P), num_threads)
    return out[..., None], failed
