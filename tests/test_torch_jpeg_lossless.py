"""Lossless JPEG (SOF3) through the port's decoder
(adanerf_tpu_torch/data/jpeg.py) against imageio, the JAX package's reader
(PIL on libjpeg-turbo), on the CPU, exactly:

* the committed fixtures (``tests/torch_fixtures/jpeg/lossless``, written
  by libjpeg-turbo through ``tests/make_jpeg_process_fixtures.py``:
  predictors 1-7, point transforms 0 and 2, greyscale and RGB, with and
  without restart intervals), which the card run holds the decoder to;
* files made from them here: libjpeg's colour-space inference (an RGB
  file without its Adobe marker, with component ids 1, 2, 3 or 4, 5, 6:
  RGB; with a JFIF marker or an Adobe transform 1: YCbCr, which
  libjpeg-turbo does not convert in a lossless file, so both sides refuse
  it), a restart interval that is not whole rows (both refuse), truncated
  files (refused);
* ``demo/llff_scene_ljpeg``, ``demo/llff_scene_jpeg``'s 32 decoded images
  written as SOF3 RGB at predictors cycling 1-7: those pixels exactly,
  ``load_llff_data`` equal to the JAX package's, and its
  ``convert_llff -factor 1`` at the pin of ``tests/torch_fixtures/
  llff_jpeg.json`` (the host time of the decode is printed)."""

import glob
import io
import json
import os
import shutil
import struct
import time

import imageio.v2 as imageio
import numpy as np
import pytest

from adanerf_tpu.data import llff as j_llff
from adanerf_tpu_torch.data import jpeg
from adanerf_tpu_torch.data import llff as t_llff

from make_jpeg_process_fixtures import LLFF_JPEG, LLFF_LJPEG, LOSSLESS, LOSSLESS_DIR
from test_torch_llff_jpeg import PINNED, PNG_SCENE, _convert_port, _jsons, mean_psnr_vs_png

NAMES = sorted(os.listdir(os.path.join(LLFF_JPEG, "images")))
RGB_FILE = os.path.join(LOSSLESS_DIR, "l6_rgb_37x29.jpg")
JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _segments(data):
    """(marker, offset, end) of each segment up to the first scan."""
    out, at = [], 2
    while True:
        marker = data[at + 1]
        n = struct.unpack(">H", data[at + 2:at + 4])[0]
        out.append((marker, at, at + 2 + n))
        if marker == 0xDA:
            return out
        at += 2 + n


def _without_adobe(data):
    for marker, at, end in _segments(data):
        if marker == 0xEE:
            return data[:at] + data[end:]
    raise AssertionError("no Adobe marker")


def _with_ids(data, ids):
    """The frame's and the scan's component ids set to ``ids``."""
    data = bytearray(data)
    for marker, at, _ in _segments(bytes(data)):
        if marker == 0xC3:
            for k in range(3):
                data[at + 10 + 3 * k] = ids[k]
        elif marker == 0xDA:
            for k in range(3):
                data[at + 5 + 2 * k] = ids[k]
    return bytes(data)


def _with_adobe_transform(data, transform):
    data = bytearray(data)
    for marker, at, _ in _segments(bytes(data)):
        if marker == 0xEE:
            data[at + 4 + 11] = transform
    return bytes(data)


def test_fixture_folder_holds_the_cases():
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(LOSSLESS_DIR, "*.jpg")))
    assert names == sorted(LOSSLESS)


@pytest.mark.parametrize("name", sorted(LOSSLESS))
def test_committed_fixtures_decode_to_their_pixels(name):
    h, w, c, predictor, pt, rows = LOSSLESS[name]
    path = os.path.join(LOSSLESS_DIR, name + ".jpg")
    data = _read(path)
    assert b"\xff\xc3" in data and (b"\xff\xdd" in data) == bool(rows)
    sos = data.index(b"\xff\xda")
    ns = data[sos + 4]
    assert data[sos + 5 + 2 * ns] == predictor and data[sos + 7 + 2 * ns] & 15 == pt
    got = jpeg.read_jpeg(path)
    np.testing.assert_array_equal(got, np.load(path[:-4] + ".npy"))
    np.testing.assert_array_equal(got, imageio.imread(path))
    assert jpeg.probe_jpeg(data) == (h, w, c)
    if pt:  # the point transform's zero bits come back shifted in
        assert not (got & ((1 << pt) - 1)).any()


@pytest.mark.parametrize("variant", ["rgb ids, no marker", "ids 1 2 3, no marker",
                                     "ids 4 5 6, no marker"])
def test_colour_space_inference_reads_rgb(variant):
    """Without a JFIF or Adobe marker libjpeg-turbo reads a 3-component
    lossless file as RGB whatever its component ids."""
    data = _without_adobe(_read(RGB_FILE))
    if variant != "rgb ids, no marker":
        data = _with_ids(data, [1, 2, 3] if "1 2 3" in variant else [4, 5, 6])
    got = jpeg.decode_jpeg(data)
    np.testing.assert_array_equal(got, imageio.imread(io.BytesIO(data)))
    np.testing.assert_array_equal(got, np.load(RGB_FILE[:-4] + ".npy"))


@pytest.mark.parametrize("variant", ["jfif", "adobe transform 1", "jfif and adobe transform 0"])
def test_lossless_ycbcr_is_refused_as_imageio_refuses_it(variant):
    data = _read(RGB_FILE)
    if variant == "jfif":
        data = data[:2] + JFIF + _without_adobe(data)[2:]
    elif variant == "adobe transform 1":
        data = _with_adobe_transform(data, 1)
    else:
        data = data[:2] + JFIF + data[2:]
    with pytest.raises(ValueError, match="lossless frame read as YCbCr.*imageio.*item 23"):
        jpeg.decode_jpeg(data)
    with pytest.raises(ValueError, match="YCbCr"):
        jpeg.probe_jpeg(data)
    with pytest.raises(OSError):
        imageio.imread(io.BytesIO(data))


def test_restart_interval_of_part_of_a_row_is_refused_as_imageio_refuses_it():
    """libjpeg-turbo (jddiffct.c) takes lossless restart intervals of whole
    rows of MCUs only."""
    data = bytearray(_read(os.path.join(LOSSLESS_DIR, "l3_rgb_29x37_restart.jpg")))
    at = data.index(b"\xff\xdd")
    data[at + 4:at + 6] = struct.pack(">H", 50)  # 37 MCUs a row
    with pytest.raises(ValueError, match="restart interval of 50 MCUs"):
        jpeg.decode_jpeg(bytes(data))
    with pytest.raises(OSError):
        imageio.imread(io.BytesIO(bytes(data)))


@pytest.mark.parametrize("keep", [0.3, 0.7, 0.99])
def test_truncated_lossless_file_is_refused(keep):
    data = _read(os.path.join(LOSSLESS_DIR, "l7_rgb_29x37_restart.jpg"))
    with pytest.raises(ValueError, match="truncated|corrupt"):
        jpeg.decode_jpeg(data[:int(len(data) * keep)])


def test_the_lossless_capture_is_the_jpeg_captures_pixels():
    assert sorted(os.listdir(os.path.join(LLFF_LJPEG, "images"))) == NAMES and len(NAMES) == 32
    assert np.array_equal(np.load(os.path.join(LLFF_LJPEG, "poses_bounds.npy")),
                          np.load(os.path.join(LLFF_JPEG, "poses_bounds.npy")))
    t = time.perf_counter()
    got = [jpeg.read_jpeg(os.path.join(LLFF_LJPEG, "images", n)) for n in NAMES]
    seconds = time.perf_counter() - t
    print(f"demo/llff_scene_ljpeg: 32 images {got[0].shape} decoded in {seconds:.2f} s of host "
          f"CPU ({1e3 * seconds / 32:.1f} ms an image)")
    predictors = set()
    for n, img in zip(NAMES, got):
        data = _read(os.path.join(LLFF_LJPEG, "images", n))
        sos = data.index(b"\xff\xda")
        predictors.add(data[sos + 5 + 2 * data[sos + 4]])
        np.testing.assert_array_equal(img, jpeg.read_jpeg(os.path.join(LLFF_JPEG, "images", n)))
        np.testing.assert_array_equal(img, imageio.imread(os.path.join(LLFF_JPEG, "images", n)))
    assert predictors == set(range(1, 8))


@pytest.mark.parametrize("factor", [1, 2])
def test_load_llff_data_on_the_lossless_capture_matches_jax(factor):
    got = t_llff.load_llff_data(LLFF_LJPEG, factor=factor, recenter=True, bd_factor=0.75)
    want = j_llff.load_llff_data(LLFF_LJPEG, factor=factor, recenter=True, bd_factor=0.75)
    assert got[0].shape == (32, 240 // factor, 320 // factor, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_conversion_of_the_lossless_capture_meets_the_pin(tmp_path):
    d = str(tmp_path / "scene")
    shutil.copytree(LLFF_LJPEG, d)
    _convert_port(d, 1)
    assert _jsons(d) == _jsons(PNG_SCENE)
    with open(PINNED) as f:
        pinned = json.load(f)
    mean, n = mean_psnr_vs_png(d)
    print(f"demo/llff_scene_ljpeg -factor 1: {mean:.6f} dB over {n} images (pinned "
          f"{pinned['mean_psnr_db']:.6f})")
    assert n == pinned["images"] and abs(mean - pinned["mean_psnr_db"]) <= pinned["bar_db"]
