"""Every PNG the JAX package reads, through the port's decoder
(adanerf_tpu_torch/data/png.py) and its two readings:

* ``read_png`` against ``imageio.v2.imread``: shape, dtype and values,
  exactly, on every legal (colour type, bit depth) x interlace 0/1 x tRNS
  where legal, and Adam7 images whose later passes are partly or wholly
  empty (``tests/torch_fixtures/png/``, written by
  ``tests/make_png_fixtures.py`` through ``tests/png_format_writer.py``,
  each with imageio's array pinned);
* ``read_png(rgb=True)`` against the JAX package's native loader
  (``adanerf_tpu/native/dataloader.cpp``, compiled here into a temporary
  directory): the RGB bytes exactly, and the dataset's floats at scales 1
  and 2 within one float32 ulp (the loader multiplies by ``1.0f / 255.0f``,
  the port divides by 255 as the JAX package's imageio fallback does),
  and exactly against that fallback where it reads the file (ROADMAP
  Queue 3, F11: it fails on greyscale and greyscale+alpha);
* the refusals that remain, by name;
* demo/mscene re-encoded as 16-bit RGB and Adam7 RGB: the port's dataset
  arrays equal the original's bit for bit.

The callers that follow imageio are held on these arrays in
``tests/test_torch_image_callers.py``.
"""

import glob
import os
import shutil
import struct
import types
import warnings
import zlib

import numpy as np
import pytest

import imageio.v2 as imageio

from adanerf_tpu.data import dataset as j_dataset
from adanerf_tpu_torch.data import dataset as t_dataset
from adanerf_tpu_torch.data.png import image_format, read_png, read_pngs

import png_format_writer as pw
from make_png_fixtures import FIXTURES, native_loader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSCENE = os.path.join(ROOT, "demo", "mscene")
NAMES = sorted(pw.fixtures())
SIZES = {name: (kw["h"], kw["w"]) for name, kw in pw.fixtures().items()}


def _path(name):
    return os.path.join(FIXTURES, name + ".png")


def _imread(path):
    with warnings.catch_warnings():  # Pillow warns on a palette with tRNS
        warnings.simplefilter("ignore")
        return imageio.imread(path)


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    if shutil.which("g++") is None or not os.path.exists("/usr/include/png.h"):
        pytest.skip("the JAX package's native loader needs g++ and libpng's png.h, absent here")
    return native_loader(str(tmp_path_factory.mktemp("native")))


def test_the_fixtures_cover_every_legal_format():
    pairs = {(kw["colour"], kw["depth"], kw["interlace"], kw["trns"])
             for kw in pw.fixtures().values()}
    legal = {(c, d, i, t) for c, ds in pw.DEPTHS.items() for d in ds for i in (0, 1)
             for t in ((False, True) if c in (0, 2, 3) else (False,))}
    assert pairs == legal and len(NAMES) == len(legal) + 6


@pytest.mark.parametrize("name", NAMES)
def test_decodes_as_imageio(name):
    """The committed file's bytes are the writer's, and the port reads
    them as imageio does here and as its pinned array."""
    with open(_path(name), "rb") as f:
        assert f.read() == pw.case_file(**pw.fixtures()[name])
    got, want, pin = read_png(_path(name)), _imread(_path(name)), np.load(_path(name)[:-4] + ".npy")
    assert got.shape == want.shape == pin.shape and got.dtype == want.dtype == pin.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pin)


@pytest.mark.parametrize("name", NAMES)
def test_rgb_reading_matches_the_native_loader(native, name):
    h, w = SIZES[name]
    got = read_png(_path(name), rgb=True)
    floats = native(_path(name), h, w)
    assert floats is not None, "the native loader failed"
    want = np.round(floats * 255)
    assert np.abs(want / 255 - floats).max() < 6e-8  # whole bytes over 255
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    np.testing.assert_array_equal(got, np.load(_path(name)[:-4] + ".rgb.npy"))


def _color_image(module, path, img, scale, h, w):
    """The dataset's ``_color_image`` of a split of (h, w) at ``scale``."""
    fake = types.SimpleNamespace(scale=scale, h=h // scale, w=w // scale)
    return module.ViewCellDataset._color_image(fake, img, path)


@pytest.mark.parametrize("scale", [1, 2])
def test_dataset_floats_match_the_native_loader_within_an_ulp(native, scale):
    worst, differ, total = 0.0, 0, 0
    for name in NAMES:
        h, w = SIZES[name]
        if min(h, w) < scale:
            continue
        got = _color_image(t_dataset, _path(name), read_png(_path(name), rgb=True), scale, h, w)
        want = native(_path(name), h, w, scale)
        assert got.shape == want.shape and got.dtype == np.float32
        worst = max(worst, float(np.abs(got - want).max()))
        differ += int((got != want).sum())
        total += got.size
    print(f"scale {scale}: {differ} of {total} values differ, worst {worst:.3e}")
    assert worst <= 6e-8


@pytest.mark.parametrize("name", NAMES)
def test_dataset_floats_match_the_jax_imageio_fallback_or_f11(name):
    """Where the JAX dataset's imageio fallback reads the file, the port's
    floats are its floats exactly; on greyscale and greyscale+alpha it
    fails (F11: Pillow gives greyscale as (h, w) and 8-bit greyscale+alpha
    as (h, w, 2); 16-bit greyscale+alpha it gives as RGBA), where the port
    reads what the native loader reads."""
    h, w = SIZES[name]
    got = _color_image(t_dataset, _path(name), read_png(_path(name), rgb=True), 1, h, w)
    fake = types.SimpleNamespace(scale=1, h=h, w=w)
    kw = pw.fixtures()[name]
    if kw["colour"] == 0 or (kw["colour"] == 4 and kw["depth"] == 8):
        with pytest.raises((IndexError, ValueError)):
            full = np.zeros((1, h, w, 3), np.float32)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                full[0] = j_dataset.ViewCellDataset.load_color_image(fake, _path(name))
        grey = read_png(_path(name), rgb=True)
        assert (grey[..., 0] == grey[..., 1]).all() and (grey[..., 1] == grey[..., 2]).all()
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_dataset.ViewCellDataset.load_color_image(fake, _path(name))
    np.testing.assert_array_equal(got, want)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _refused(case):
    """A file the port refuses, and the words its message names."""
    good = pw.encode(np.zeros((3, 4, 3), np.uint8), 2, 8)
    ihdr = bytearray(good[16:29])  # IHDR's body
    if case == "bad_crc":  # the last byte of IHDR's CRC flipped
        return good[:32] + bytes([good[32] ^ 1]) + good[33:], "the CRC of its 'IHDR' chunk"
    if case == "row_filter_5":
        raw = b"".join(b"\x05" + bytes(12) for _ in range(3))
        return pw.SIGNATURE + _chunk(b"IHDR", bytes(ihdr)) + \
            _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""), "unknown PNG row filter 5"
    if case == "no_plte":
        return pw.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 3, 8, 3, 0, 0, 0)) + \
            _chunk(b"IDAT", zlib.compress(bytes(15))) + _chunk(b"IEND", b""), "without a PLTE"
    field, value, words = {
        "palette_16": (9, 3, "bit depth 16, colour type 3 (palette)"),
        "rgb_4": (8, 4, "bit depth 4, colour type 2 (RGB)"),
        "grey_3": (8, 3, "bit depth 3, colour type 0 (greyscale)"),
        "colour_5": (9, 5, "colour type 5 (unknown)"),
        "compression_1": (10, 1, "compression method 1"),
        "filter_method_1": (11, 1, "filter method 1"),
        "interlace_2": (12, 2, "interlace 2"),
    }[case]
    if case in ("palette_16", "grey_3", "colour_5"):
        ihdr[8] = {"palette_16": 16, "grey_3": 3, "colour_5": 8}[case]
        ihdr[9] = {"palette_16": 3, "grey_3": 0, "colour_5": 5}[case]
    else:
        ihdr[field] = value
    return pw.SIGNATURE + _chunk(b"IHDR", bytes(ihdr)) + good[33:], words


@pytest.mark.parametrize("case", ["palette_16", "rgb_4", "grey_3", "colour_5", "compression_1",
                                  "filter_method_1", "interlace_2", "bad_crc", "row_filter_5",
                                  "no_plte"])
def test_what_remains_refused_is_refused_by_name(tmp_path, case):
    data, words = _refused(case)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    for rgb in (False, True):
        with pytest.raises(ValueError, match="PNG") as err:
            read_png(str(path), rgb=rgb)
        assert words in str(err.value) and str(path) in str(err.value)


@pytest.fixture(scope="module")
def reencoded(tmp_path_factory):
    """A copy of demo/mscene's train split whose PNGs are re-encoded
    losslessly, even-numbered frames as 16-bit RGB, odd as Adam7 RGB."""
    d = str(tmp_path_factory.mktemp("mscene") / "mscene")
    os.makedirs(os.path.join(d, "train"))
    for f in ("dataset_info.json", "transforms_train.json"):
        shutil.copy(os.path.join(MSCENE, f), d)
    for i, path in enumerate(sorted(glob.glob(os.path.join(MSCENE, "train", "*.png")))):
        with open(os.path.join(d, "train", os.path.basename(path)), "wb") as f:
            f.write(pw.reencode(read_png(path, rgb=True), "adam7" if i % 2 else "rgb16"))
    return d


def test_reencoded_mscene_dataset_is_the_original_bit_for_bit(reencoded, tmp_path):
    from adanerf_tpu_torch.config import Config
    from scene_utils import dense_config_args
    arrays = []
    for scene in (MSCENE, reencoded):
        cfg = Config.init(argv=dense_config_args(scene, str(tmp_path / "logs"))
                          + ["--device", "cpu"])
        arrays.append(t_dataset.ViewCellDataset(cfg, t_dataset.DatasetInfo(cfg), "train",
                                                32).color_images)
    assert arrays[0].shape == (36, 400, 400, 3)
    assert np.array_equal(arrays[0], arrays[1])


def test_reencoded_files_are_the_formats_named(reencoded):
    files = sorted(glob.glob(os.path.join(reencoded, "train", "*.png")))
    assert [image_format(f) for f in files[:2]] == ["16-bit RGB PNG", "8-bit RGB PNG"]
    img = _imread(files[0])
    np.testing.assert_array_equal(read_png(files[0]), img)  # imageio: the high bytes
    np.testing.assert_array_equal(read_pngs(files[1:2])[0], _imread(files[1]))


def test_f11_the_jax_readers_round_one_ulp_apart_on_mscene(native):
    """F11: on 8-bit RGB, which both JAX readers read, the native loader's
    ``byte * (1.0f / 255.0f)`` and the imageio fallback's ``byte / 255``
    differ by one float32 ulp on part of the values; the port follows the
    fallback."""
    paths = sorted(glob.glob(os.path.join(MSCENE, "train", "*.png")))[:4]
    for scale in (1, 2):
        got = np.stack([_color_image(t_dataset, p, img, scale, 400, 400)
                        for p, img in zip(paths, read_pngs(paths, rgb=True))])
        fake = types.SimpleNamespace(scale=scale, h=400 // scale, w=400 // scale)
        fallback = np.stack([j_dataset.ViewCellDataset.load_color_image(fake, p) for p in paths])
        loader = np.stack([native(p, 400, 400, scale) for p in paths])
        np.testing.assert_array_equal(got, fallback)
        share = float((loader != fallback).mean())
        worst = float(np.abs(loader - fallback).max())
        print(f"scale {scale}: the two JAX readers differ on {100 * share:.1f}% of the values, "
              f"worst {worst:.3e}")
        assert 0 < share < 1 and worst <= 6e-8
