"""The port's host-side helpers that stand in for yaml, PIL and matplotlib
(which need not be installed beside the card), each held against the package
it replaces, and the data pipeline against pai_tpu.data."""

import zlib

import numpy as np
import pytest
import torch

from pai_tpu_torch.data import BatchLoader, ImageDataset, load_manifest
from pai_tpu_torch.data.manifest import parse_manifest
from pai_tpu_torch.data.pipeline import load_example_u8, resize_antialias
from pai_tpu_torch.utils import images as ti
from torch_port_util import write_blob_dataset

MANIFEST = """\
# a comment
- input: in_0.png
  ground_truth: gt_0.png

- input: "sub dir/in 1.png"   # quoted, with a trailing comment
  ground_truth: 'gt_1.png'
-   input: ../in_2.png
    ground_truth: gt_2.png # plain scalar, trailing comment
"""


def test_manifest_parser_matches_yaml(tmp_path):
    import yaml

    assert parse_manifest(MANIFEST) == yaml.safe_load(MANIFEST)
    generated = "".join(f"- input: in_{i}.png\n  ground_truth: gt_{i}.png\n"
                        for i in range(7))
    assert parse_manifest(generated) == yaml.safe_load(generated)

    path = tmp_path / "nested" / "data.yaml"
    path.parent.mkdir()
    path.write_text(MANIFEST)
    from pai_tpu.data import load_manifest as jax_load_manifest

    assert load_manifest(str(path)) == jax_load_manifest(str(path))


@pytest.mark.parametrize("text", [
    "input: a.png\nground_truth: b.png\n",          # a mapping, not a list
    "- input: a.png\n",                             # missing key
    "- input: a.png\n  ground_truth: b.png\n  extra: c\n",
    "- input a.png\n  ground_truth: b.png\n",       # no colon
    "- [a.png, b.png]\n",
])
def test_manifest_parser_rejects_other_shapes(text):
    with pytest.raises(ValueError):
        parse_manifest(text)


@pytest.mark.parametrize("shape", [(17, 23), (16, 16, 1), (9, 14, 3)])
@pytest.mark.parametrize("level", [0, 6])
def test_png_writer_is_read_by_pil(tmp_path, shape, level):
    from PIL import Image

    arr = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    ti.write_png(arr, path, compress_level=level)
    with Image.open(path) as im:
        got = np.asarray(im)
    want = arr[..., 0] if arr.ndim == 3 and arr.shape[-1] == 1 else arr
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ti.read_png(path), want)


def _smooth(rng, h, w, c):
    """Smooth content, so PIL's adaptive filtering picks every filter type."""
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [127 + 100 * np.sin(xx / rng.uniform(2, 9) + k)
              * np.cos(yy / rng.uniform(2, 9)) + rng.normal(0, 3, (h, w))
              for k in range(c)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def _filter_types(path):
    """The set of filter bytes a PNG file uses."""
    data = open(path, "rb").read()
    pos, idat, header = 8, [], None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            header = data[pos + 8:pos + 8 + n]
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w = int.from_bytes(header[0:4], "big")
    h = int.from_bytes(header[4:8], "big")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[header[9]]
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * (w * channels + 1)] for y in range(h)}


@pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3), ("LA", 2),
                                           ("RGBA", 4)])
def test_png_reader_matches_pil_on_filtered_compressed_files(tmp_path, mode,
                                                             channels):
    from PIL import Image

    from pai_tpu.utils.images import read_png_gray as jax_read_png_gray

    rng = np.random.default_rng(1)
    arr = _smooth(rng, 40, 52, channels)
    path = str(tmp_path / "b.png")
    Image.fromarray(arr[..., 0] if channels == 1 else arr, mode).save(
        path, compress_level=6)
    if mode in ("L", "RGB"):
        assert len(_filter_types(path)) >= 3  # Sub/Up/Average/Paeth in play
    got = ti.read_png(path)
    np.testing.assert_array_equal(got, arr[..., 0] if channels == 1 else arr)

    gray = ti.read_png_gray(path)
    with Image.open(path) as im:
        want = np.asarray(im.convert("L"))
    assert gray.shape == (40, 52) and gray.dtype == np.uint8
    # the port reads through its copy of the JAX package's C++ codec (float
    # luma coefficients): byte-equal to that codec, to the JAX package's
    # reader and to the plain version; PIL's fixed-point luma agrees on gray
    # files and within one grey level on RGB
    from pai_tpu.native import png_native as jax_png_native

    np.testing.assert_array_equal(gray, jax_png_native.read_png_gray(path))
    np.testing.assert_array_equal(gray, jax_read_png_gray(path))
    np.testing.assert_array_equal(gray, ti.read_png_gray_plain(path))
    if mode == "L":
        np.testing.assert_array_equal(gray, want)
    elif mode == "RGB":
        assert int(np.abs(gray.astype(int) - want.astype(int)).max()) <= 1


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reader_undoes_each_filter_type(tmp_path, ftype):
    """A hand-filtered RGB file per filter type, against a straight
    per-byte implementation of the PNG specification's filters."""
    rng = np.random.default_rng(ftype)
    arr = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    bpp, stride = 3, 21
    flat = arr.reshape(6, stride).astype(int)
    rows = bytearray()
    for y in range(6):
        rows.append(ftype)
        for i in range(stride):
            a = flat[y, i - bpp] if i >= bpp else 0
            b = flat[y - 1, i] if y else 0
            c = flat[y - 1, i - bpp] if (y and i >= bpp) else 0
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
            rows.append((flat[y, i] - pred) % 256)
    import struct

    ihdr = struct.pack(">IIBBBBB", 7, 6, 8, 2, 0, 0, 0)
    path = tmp_path / "f.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + ti._chunk(b"IHDR", ihdr)
                     + ti._chunk(b"IDAT", zlib.compress(bytes(rows)))
                     + ti._chunk(b"IEND", b""))
    np.testing.assert_array_equal(ti.read_png(str(path)), arr)


def test_png_reader_rejects_what_it_does_not_read(tmp_path):
    """A sub-byte depth (a 4-bit palette) and a file that is no PNG: the
    plain reader and the native codec both refuse them, with the reason."""
    from PIL import Image

    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(path,
                                                                  bits=4)
    with pytest.raises(ValueError, match="only 8- and 16-bit"):
        ti.read_png(path)
    with pytest.raises(ValueError, match="unsupported PNG"):
        ti.read_png_gray(path)
    (tmp_path / "n.png").write_bytes(b"not a png")
    for read in (ti.read_png, ti.read_png_gray):
        with pytest.raises(ValueError, match="not a PNG"):
            read(str(tmp_path / "n.png"))
    with pytest.raises(TypeError):
        ti.write_png(np.zeros((4, 4), np.float32), path)


def test_afmhot_lut_matches_matplotlib():
    from matplotlib import colormaps

    want = colormaps["afmhot"](np.linspace(0.0, 1.0, 256))[:, :3]
    np.testing.assert_allclose(ti.afmhot_lut(), want, atol=1e-6, rtol=0)

    from pai_tpu.utils.images import afmhot_rgb as jax_afmhot_rgb

    img = np.random.default_rng(2).uniform(0, 1, (20, 30)).astype(np.float32)
    img[0, :3] = (0.0, 1.0, 0.5)
    np.testing.assert_allclose(ti.afmhot_rgb(img), jax_afmhot_rgb(img),
                               atol=1e-6, rtol=0)
    # and what matplotlib itself does with the image
    np.testing.assert_allclose(ti.afmhot_rgb(img),
                               colormaps["afmhot"](img)[..., :3], atol=1e-6,
                               rtol=0)


def test_denormalize_and_to_int_match_jax():
    import jax.numpy as jnp

    from pai_tpu.utils import images as ji

    x = np.random.default_rng(3).uniform(-1.5, 1.5, (2, 8, 8, 1)
                                         ).astype(np.float32)
    np.testing.assert_array_equal(
        ti.denormalize(torch.from_numpy(x)).numpy(),
        np.asarray(ji.denormalize(jnp.asarray(x))))
    # every bin edge of the 255 + 1 - 1e-3 scale, and beyond the range
    u = np.concatenate([np.linspace(0, 1, 4097), [-0.1, 1.2, 0.999999]]
                       ).astype(np.float32)
    want = np.asarray(ji.to_int(jnp.asarray(u)))
    np.testing.assert_array_equal(ti.to_int(torch.from_numpy(u)).numpy(),
                                  want)
    np.testing.assert_array_equal(ti.to_int(u), ji.to_int_np(u))
    assert ti.to_int(u).dtype == np.uint8
    assert ti.to_int(torch.from_numpy(u)).dtype == torch.uint8


def test_resize_antialias_matches_pil_within_one_level(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    for shape in ((64, 64), (50, 70), (20, 24)):  # down, mixed, up
        img = _smooth(rng, shape[0], shape[1], 1)[..., 0]
        got = np.clip(resize_antialias(img, 32) + 0.5, 0, 255).astype(
            np.uint8)
        want = np.asarray(Image.fromarray(img).resize((32, 32),
                                                      Image.BILINEAR))
        assert got.shape == (32, 32)
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    # a file of another size is resized on load, like the JAX loader does
    from pai_tpu.data.pipeline import load_example_u8 as jax_load_example_u8

    big = _smooth(rng, 48, 48, 1)[..., 0]
    ti.write_png(big, str(tmp_path / "big.png"))
    pair = (str(tmp_path / "big.png"), str(tmp_path / "big.png"))
    ours = load_example_u8(pair, 32)[0]
    theirs = jax_load_example_u8(pair, 32)[0]
    assert ours.shape == theirs.shape == (32, 32, 1)
    assert int(np.abs(ours.astype(int) - theirs.astype(int)).max()) <= 1


@pytest.mark.parametrize("pad_mode", ["zero", "cycle"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_loader_matches_jax_loader(tmp_path, pad_mode, shuffle):
    """Same order (per-epoch seeded), same padding, same n_valid, same
    normalised values, over two epochs."""
    from pai_tpu.data import BatchLoader as JaxBatchLoader
    from pai_tpu.data import ImageDataset as JaxImageDataset

    manifest = write_blob_dataset(tmp_path, 7, 16, seed=5,
                                  write_png=ti.write_png)
    ours = BatchLoader(ImageDataset(manifest, 16), 3, shuffle=shuffle,
                       pad_mode=pad_mode, seed=11, num_workers=2,
                       device="cpu")
    theirs = JaxBatchLoader(JaxImageDataset(manifest, 16), 3, shuffle=shuffle,
                            pad_mode=pad_mode, seed=11, num_workers=2)
    assert len(ours) == len(theirs) == 3
    firsts = []
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.n_valid == b.n_valid
            assert a.x.shape == (3, 16, 16, 1) and a.x.dtype == torch.float32
            np.testing.assert_array_equal(a.x.numpy(), np.asarray(b.x))
            np.testing.assert_array_equal(a.y.numpy(), np.asarray(b.y))
        assert got[-1].n_valid == 1
        if pad_mode == "zero":  # zero uint8 rows normalise to -1
            assert float(got[-1].x[1:].max()) == -1.0
        firsts.append(got[0].x.numpy())
    assert shuffle != np.array_equal(firsts[0], firsts[1])


def test_dataset_items_match_jax(tmp_path):
    from pai_tpu.data import ImageDataset as JaxImageDataset

    manifest = write_blob_dataset(tmp_path, 2, 16, seed=6,
                                  write_png=ti.write_png)
    ours, theirs = ImageDataset(manifest, 16), JaxImageDataset(manifest, 16)
    assert len(ours) == len(theirs) == 2
    for (ax, ay), (bx, by) in zip((ours[0], ours[1]),
                                  (theirs[0], theirs[1])):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def test_loader_hands_decode_errors_to_the_consumer(tmp_path):
    manifest = write_blob_dataset(tmp_path, 2, 16, seed=7,
                                  write_png=ti.write_png)
    (tmp_path / "in_1.png").write_bytes(b"broken")
    loader = BatchLoader(ImageDataset(manifest, 16), 2, pad_mode="zero",
                         num_workers=1, device="cpu")
    with pytest.raises(ValueError, match="not a PNG"):
        list(loader)
