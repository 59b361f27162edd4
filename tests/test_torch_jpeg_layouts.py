"""The JPEG layouts of ROADMAP Queue 1, item 24, through the port's decoder
(adanerf_tpu_torch/data/jpeg.py) against imageio, the JAX package's reader
(Pillow on libjpeg-turbo), on the CPU:

* the committed fixtures (``tests/torch_fixtures/jpeg/layouts``, written
  by libjpeg-turbo through ``tests/make_jpeg_process_fixtures.py``):
  sampling factors of 3 and 4 (4:1:1, 4:1:0, 1x4, 3x1, 3x2, mixed
  ratios, planes 1 and 2 samples wide), 4 components (CMYK and YCCK, with
  and without an Adobe marker, Pillow's own CMYK file) and lossless frames
  with subsampling, sequential, progressive, arithmetic-coded and
  lossless: imageio's pixels exactly, and the JAX package's LLFF loader's
  floats through the port's (a CMYK capture trains on C, M, Y as R, G, B:
  ROADMAP Queue 3, F12, the JAX package's, kept);
* what imageio refuses, refused by name beside imageio's refusal: 2
  components, factors above 4, a ratio that is not whole, more than 10
  blocks in an MCU, a lossless YCCK frame;
* ``demo/llff_scene_411``, ``demo/llff_scene_jpeg``'s 32 images re-encoded
  4:1:1: imageio's pixels exactly, ``load_llff_data`` equal to the JAX
  package's, and the decode and its ``convert_llff -factor 1`` at the pins
  of ``tests/torch_fixtures/llff_411.json``."""

import glob
import io
import json
import os
import shutil
import time

import imageio.v2 as imageio
import numpy as np
import pytest

from adanerf_tpu.data import llff as j_llff
from adanerf_tpu_torch.data import jpeg
from adanerf_tpu_torch.data import llff as t_llff
from adanerf_tpu_torch.data.png import check_image, read_png

from make_jpeg_process_fixtures import (LAYOUTS, LAYOUTS_DIR, LLFF_411, LLFF_JPEG, PINNED_411,
                                        REFUSED_DIR)
from test_torch_jpeg_lossless import _without_adobe
from test_torch_llff_jpeg import PNG_SCENE, _convert_port, _jsons, mean_psnr_vs_png

NAMES = sorted(os.path.basename(p)[:-4] for p in glob.glob(os.path.join(LAYOUTS_DIR, "*.jpg")))
CAPTURE = sorted(os.listdir(os.path.join(LLFF_411, "images")))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _path(name):
    return os.path.join(LAYOUTS_DIR, name + ".jpg")


def test_every_layout_has_its_fixture():
    assert NAMES == sorted(list(LAYOUTS) + ["cmyk_pil_q90_23x19"])


@pytest.mark.parametrize("name", NAMES)
def test_layout_decodes_to_imageio_pixels(name):
    got, pin = jpeg.read_jpeg(_path(name)), np.load(_path(name)[:-4] + ".npy")
    want = imageio.imread(_path(name))
    assert got.shape == pin.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, pin)
    np.testing.assert_array_equal(got, want)
    h, w, n = jpeg.probe_jpeg(_read(_path(name)))
    assert (h, w) == got.shape[:2] and n == (1 if got.ndim == 2 else got.shape[2])


@pytest.mark.parametrize("name", NAMES)
def test_layout_through_the_llff_loaders(tmp_path, name):
    """Each fixture as a one-image capture's ``images/``: the JAX loader's
    floats (imageio, ``/ 255``, ``[..., :3]``) and the port's alike; for 4
    channels those are C, M and Y (F12)."""
    (tmp_path / "images").mkdir()
    shutil.copy(_path(name), tmp_path / "images" / "0000.jpg")
    want = j_llff._load_images(str(tmp_path), 1)
    got = t_llff._load_images(str(tmp_path), 1)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    pin = np.load(_path(name)[:-4] + ".npy")
    if pin.ndim == 3 and pin.shape[2] == 4:
        np.testing.assert_array_equal(got[0], pin[..., :3].astype(np.float32) / 255)


@pytest.mark.parametrize("name,same", [("cmyk_q90_17x33", True), ("ycck_q90_17x33", False),
                                       ("yccp411_q85_29x37", False)])
def test_without_its_adobe_marker_a_file_reads_as_cmyk(name, same):
    """libjpeg reads 4 components without an Adobe marker as CMYK: a CMYK
    file (Adobe transform 0) decodes the same without its marker, a YCCK
    file (transform 2) does not; imageio agrees on both."""
    data = _read(_path(name))
    bare = _without_adobe(data)
    got, want = jpeg.decode_jpeg(bare), imageio.imread(io.BytesIO(bare))
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got, jpeg.decode_jpeg(data)) == same


def _sof(data):
    for m in (b"\xff\xc0", b"\xff\xc1", b"\xff\xc2", b"\xff\xc3", b"\xff\xc9", b"\xff\xca"):
        if m in data:
            return data.index(m)
    raise AssertionError("no frame header")


def _factors(data, hv):
    """A file with its frame's sampling bytes set to ``hv``."""
    at, out = _sof(data), bytearray(data)
    for k, v in enumerate(hv):
        out[at + 11 + 3 * k] = v
    return bytes(out)


def _refused(case):
    if case == "two_components":
        return _read(os.path.join(REFUSED_DIR, "two_components.jpg")), "2 components"
    if case == "lossless_ycck":
        data = bytearray(_read(_path("l1_cmyk22_17x33")))
        at = data.index(b"Adobe")
        assert data[at + 11] == 0
        data[at + 11] = 2
        return bytes(data), "a lossless frame read as YCCK"
    y411 = _read(_path("y411_q90_29x37"))
    hv, words = {"factor_5": ([0x51, 0x11, 0x11], "libjpeg takes 1 to 4"),
                 "fractional_3_2": ([0x31, 0x21, 0x11], "not whole"),
                 "blocks_11": ([0x42, 0x21, 0x11], "11 data units in an MCU"),
                 "blocks_18": ([0x44, 0x11, 0x11], "18 data units in an MCU")}[case]
    return _factors(y411, hv), words


@pytest.mark.parametrize("case", ["two_components", "lossless_ycck", "factor_5",
                                  "fractional_3_2", "blocks_11", "blocks_18"])
def test_what_imageio_refuses_is_refused_by_name(tmp_path, case):
    data, words = _refused(case)
    with pytest.raises((OSError, SyntaxError)):
        imageio.imread(io.BytesIO(data))
    with pytest.raises(ValueError, match="imageio .* refuses too") as err:
        jpeg.decode_jpeg(data, "x.jpg")
    assert words in str(err.value) and jpeg._ITEM in str(err.value)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    if case.startswith("blocks"):  # libjpeg counts an MCU's blocks at its scans
        check_image(str(path))
    else:
        with pytest.raises(ValueError, match=words):
            check_image(str(path))


def test_the_411_capture_is_the_jpeg_captures_images_at_4_1_1():
    assert CAPTURE == sorted(os.listdir(os.path.join(LLFF_JPEG, "images"))) and len(CAPTURE) == 32
    assert np.array_equal(np.load(os.path.join(LLFF_411, "poses_bounds.npy")),
                          np.load(os.path.join(LLFF_JPEG, "poses_bounds.npy")))
    data = _read(os.path.join(LLFF_411, "images", CAPTURE[0]))
    at = _sof(data)
    assert data[at + 9] == 3 and [data[at + 11 + 3 * k] for k in range(3)] == [0x41, 0x11, 0x11]


def test_the_411_capture_decodes_to_imageio_pixels_and_its_pin():
    with open(PINNED_411) as f:
        pinned = json.load(f)
    t = time.perf_counter()
    got = [jpeg.read_jpeg(os.path.join(LLFF_411, "images", n)) for n in CAPTURE]
    seconds = time.perf_counter() - t
    print(f"demo/llff_scene_411: 32 images {got[0].shape} decoded in {seconds:.2f} s of host "
          f"CPU ({1e3 * seconds / 32:.1f} ms an image)")
    psnrs = []
    for n, img in zip(CAPTURE, got):
        np.testing.assert_array_equal(img, imageio.imread(os.path.join(LLFF_411, "images", n)))
        png = read_png(os.path.join(PNG_SCENE, "images", n[:-4] + ".png"))[..., :3]
        psnrs.append(10 * np.log10(1.0 / np.mean((img / 255.0 - png / 255.0) ** 2)))
    print(f"decode: {np.mean(psnrs):.6f} dB (pinned {pinned['decode_mean_psnr_db']:.6f})")
    assert len(psnrs) == pinned["decoded_images"]
    assert abs(np.mean(psnrs) - pinned["decode_mean_psnr_db"]) <= pinned["bar_db"]


@pytest.mark.parametrize("factor", [1, 2])
def test_load_llff_data_on_the_411_capture_matches_jax(factor):
    got = t_llff.load_llff_data(LLFF_411, factor=factor, recenter=True, bd_factor=0.75)
    want = j_llff.load_llff_data(LLFF_411, factor=factor, recenter=True, bd_factor=0.75)
    assert got[0].shape == (32, 240 // factor, 320 // factor, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=0 if factor == 1 else 1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_conversion_of_the_411_capture_meets_the_pin(tmp_path):
    d = str(tmp_path / "scene")
    shutil.copytree(LLFF_411, d)
    _convert_port(d, 1)
    assert _jsons(d) == _jsons(PNG_SCENE)
    with open(PINNED_411) as f:
        pinned = json.load(f)
    mean, n = mean_psnr_vs_png(d)
    print(f"demo/llff_scene_411 -factor 1: {mean:.6f} dB over {n} images (pinned "
          f"{pinned['mean_psnr_db']:.6f})")
    assert n == pinned["images"] and abs(mean - pinned["mean_psnr_db"]) <= pinned["bar_db"]
