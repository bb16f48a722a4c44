"""The port's native PNG codec (``pai_tpu_torch/native``) against the JAX
package's (``pai_tpu.native.png_native``, the same C++ built from its own
copy) and against the port's plain version (``utils.images``,
``data.pipeline``), on the CPU.

The files are written here by a small encoder that follows the PNG
specification byte for byte: every colour type the codec reads (gray,
gray+alpha, RGB, RGBA, 8-bit palette; 8 and 16 bits), every filter type (row
``y`` takes filter ``y % 5``), zlib levels 0 and 6, odd sizes.

Tolerances: decoded pixels and written files byte-equal to the JAX package's
codec; the plain reader byte-equal to the native one; the resize (float32)
within 1e-6 of the JAX package's; the plain resize, rounded, within one grey
level (sums in another order)."""

import os
import struct
import zlib

import numpy as np
import pytest

from pai_tpu_torch import native
from pai_tpu_torch.data.pipeline import (BatchLoader, ImageDataset,
                                         decode_u8_plain)
from pai_tpu_torch.native import png_native
from pai_tpu_torch.utils import images as ti
import torch_port_util  # noqa: F401  (one torch thread per process)

# (PNG colour type, bit depth, samples per pixel)
KINDS = {"gray": (0, 8, 1), "gray16": (0, 16, 1), "gray_alpha": (4, 8, 2),
         "rgb": (2, 8, 3), "rgb16": (2, 16, 3), "rgba": (6, 8, 4),
         "rgba16": (6, 16, 4), "palette": (3, 8, 1)}


def _filtered_rows(raw: bytes, h: int, stride: int, bpp: int) -> bytes:
    """Filter row ``y`` with type ``y % 5`` (None, Sub, Up, Average,
    Paeth)."""
    out = bytearray()
    prev = bytes(stride)
    for y in range(h):
        row = raw[y * stride:(y + 1) * stride]
        ftype = y % 5
        out.append(ftype)
        for i in range(stride):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((row[i] - pred) % 256)
        prev = row
    return bytes(out)


def encode_png(path, kind, h, w, level, seed):
    """Write a PNG of ``kind`` with smooth random content and return the
    pixels it holds ([H,W,C] uint8/uint16, or palette indices)."""
    colour, depth, channels = KINDS[kind]
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    top = 255 if depth == 8 else 65535
    planes = [(0.5 + 0.45 * np.sin(xx / rng.uniform(2, 6) + k)
               * np.cos(yy / rng.uniform(2, 6))) * top
              + rng.normal(0, top / 80, (h, w)) for k in range(channels)]
    samples = np.clip(np.stack(planes, -1), 0, top).astype(
        np.uint8 if depth == 8 else np.uint16)
    chunks = []
    if colour == 3:
        samples = (samples % 40).astype(np.uint8)  # 40-colour palette
        palette = rng.integers(0, 256, (40, 3), dtype=np.uint8)
        chunks.append((b"PLTE", palette.tobytes()))
    raw = samples.astype(">u2" if depth == 16 else np.uint8).tobytes()
    bpp = channels * depth // 8
    data = zlib.compress(_filtered_rows(raw, h, w * bpp, bpp), level)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        for kind_, body in [(b"IHDR", ihdr), *chunks, (b"IDAT", data),
                            (b"IEND", b"")]:
            f.write(ti._chunk(kind_, body))
    return samples


@pytest.fixture(scope="module")
def jax_codec():
    from pai_tpu.native import png_native as jax_png_native

    return jax_png_native


@pytest.mark.parametrize("level", [0, 6])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_read_png_gray_matches_the_jax_codec_and_the_plain_version(
        tmp_path, jax_codec, kind, level):
    path = str(tmp_path / f"{kind}.png")
    samples = encode_png(path, kind, 19, 23, level, seed=len(kind) + level)
    gray = ti.read_png_gray(path)
    assert gray.shape == (19, 23) and gray.dtype == np.uint8
    np.testing.assert_array_equal(gray, jax_codec.read_png_gray(path))
    np.testing.assert_array_equal(gray, ti.read_png_gray_plain(path))
    if kind in ("gray", "gray16", "gray_alpha"):  # no luma: the samples
        want = samples[..., 0]
        np.testing.assert_array_equal(
            gray, want if want.dtype == np.uint8 else want >> 8)


@pytest.mark.parametrize("size", [32, 20])  # the files' size, and resized
def test_decode_batch_matches_the_jax_codec(tmp_path, jax_codec, size):
    """Mixed kinds and sizes in one batch, a file that is no PNG among them
    (flagged by both codecs, its row left zero); at the files' own size the
    rows equal the plain reader's, resized within one level of the plain
    resize."""
    paths = []
    for i, kind in enumerate(sorted(KINDS)):
        path = str(tmp_path / f"{i}.png")
        encode_png(path, kind, 32 if i % 2 else 40, 32 if i % 2 else 27, 6,
                   seed=i)
        paths.append(path)
    (tmp_path / "bad.png").write_bytes(b"\x89PNG not really")
    paths.insert(3, str(tmp_path / "bad.png"))
    ours, failed = png_native.decode_batch_u8(paths, size, num_threads=3)
    theirs, their_failed = jax_codec.decode_batch_u8(paths, size,
                                                     num_threads=2)
    assert ours.shape == (len(paths), size, size, 1)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(failed.astype(bool), their_failed)
    assert list(np.flatnonzero(failed)) == [3]
    assert png_native.DECODE_ERRORS[int(failed[3])] == "not a PNG file"
    assert not ours[3].any()
    for k, path in enumerate(paths):
        if k == 3:
            continue
        plain = decode_u8_plain(path, size)
        if ti.read_png_gray(path).shape == (size, size):
            np.testing.assert_array_equal(ours[k], plain)
        else:
            diff = np.abs(ours[k].astype(int) - plain.astype(int))
            assert int(diff.max()) <= 1


@pytest.mark.parametrize("shape", [(17, 23), (16, 16, 1), (9, 14, 3)])
@pytest.mark.parametrize("level", [0, 6])
def test_write_png_writes_the_jax_codecs_file(tmp_path, jax_codec, shape,
                                              level):
    arr = np.random.default_rng(level).integers(0, 256, shape,
                                                dtype=np.uint8)
    ti.write_png(arr, str(tmp_path / "ours.png"), compress_level=level)
    jax_codec.write_png(arr, str(tmp_path / "theirs.png"), level)
    ti.write_png_plain(arr, str(tmp_path / "plain.png"), level)
    ours = (tmp_path / "ours.png").read_bytes()
    assert ours == (tmp_path / "theirs.png").read_bytes()
    want = arr[..., 0] if shape[-1] == 1 else arr
    for name in ("ours", "plain"):
        np.testing.assert_array_equal(ti.read_png(str(tmp_path /
                                                      f"{name}.png")), want)
    if arr.ndim == 2 or shape[-1] == 1:
        np.testing.assert_array_equal(
            ti.read_png_gray(str(tmp_path / "ours.png")), want)
    with pytest.raises(TypeError):
        ti.write_png(arr.astype(np.float32), str(tmp_path / "f.png"))
    with pytest.raises(ValueError):
        ti.write_png(np.zeros((4, 4, 2), np.uint8), str(tmp_path / "f.png"))


@pytest.mark.parametrize("src,dst", [((40, 27), (32, 32)), ((13, 30),
                                                            (20, 16))])
def test_resize_matches_the_jax_codec(jax_codec, src, dst):
    from pai_tpu_torch.data.pipeline import resize_antialias

    img = np.random.default_rng(9).integers(0, 256, src, dtype=np.uint8)
    ours = png_native.resize_bilinear_antialias(img, *dst)
    theirs = jax_codec.resize_bilinear_antialias(img, *dst)
    assert ours.dtype == np.float32 and ours.shape == dst
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    if dst[0] == dst[1]:  # the plain version resizes to squares
        plain = resize_antialias(img, dst[0])
        assert float(np.abs(plain - ours).max()) < 1e-3


def test_loader_names_the_file_the_codec_refuses(tmp_path):
    from torch_port_util import write_blob_dataset

    manifest = write_blob_dataset(tmp_path, 2, 16, seed=7,
                                  write_png=ti.write_png)
    encode_png(str(tmp_path / "gt_0.png"), "gray16", 16, 16, 6, seed=1)
    (tmp_path / "gt_1.png").write_bytes(
        (tmp_path / "gt_1.png").read_bytes()[:60])  # cut short
    loader = BatchLoader(ImageDataset(manifest, 16), 2, device="cpu")
    with pytest.raises(ValueError, match="gt_1.png: corrupt PNG data"):
        list(loader)


def test_codec_build_without_a_compiler_raises(tmp_path):
    """No fallback: a compiler that does not exist, or one that fails,
    raises ``NativeBuildError`` (with the compiler's stderr) and leaves no
    library behind."""
    with pytest.raises(native.NativeBuildError, match="no-such-c"):
        native.build(compiler=str(tmp_path / "no-such-c++"),
                     build_dir=str(tmp_path))
    failing = tmp_path / "failing-c++"
    failing.write_text("#!/bin/sh\necho 'cannot compile this' >&2\nexit 3\n")
    failing.chmod(0o755)
    with pytest.raises(native.NativeBuildError, match="cannot compile this"):
        native.build(compiler=str(failing), build_dir=str(tmp_path))
    assert not [f for f in tmp_path.iterdir() if f.suffix in (".so", ".tmp")]
    # the real build is named by the source and the flags, and logged
    path = native.build()
    assert path == native.library_path()
    assert os.path.exists(path) and os.path.exists(path + ".log")
