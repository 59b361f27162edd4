"""Arithmetic-coded JPEG (SOF9 sequential, SOF10 progressive) through the
port's decoder (adanerf_tpu_torch/data/jpeg.py) against imageio, the JAX
package's reader (PIL on libjpeg-turbo), on the CPU, exactly:

* the committed fixtures (``tests/torch_fixtures/jpeg/arith``, written by
  ``tests/make_jpeg_process_fixtures.py``: PIL's Huffman files transcoded
  to arithmetic coding by libjpeg-turbo, 4:4:4, 4:2:2, 4:2:0 and
  greyscale, odd sizes, with and without restart intervals, a DAC segment
  of non-default L, U and Kx), which the card run holds the decoder to;
* files made from them here: an EXIF block and a comment inserted, the DAC
  conditioning rewritten (the bits then decode to other coefficients, the
  same on both sides), truncated files (refused);
* ``demo/llff_scene_ajpeg``, ``demo/llff_scene_jpeg``'s 32 images
  transcoded (even-numbered SOF9, odd-numbered SOF10): the same pixels as
  that capture, ``load_llff_data`` equal to the JAX package's, and its
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

from make_jpeg_process_fixtures import ARITH, ARITH_DIR, LLFF_AJPEG, LLFF_JPEG
from test_torch_llff_jpeg import PINNED, PNG_SCENE, _convert_port, _jsons, mean_psnr_vs_png

NAMES = sorted(os.listdir(os.path.join(LLFF_JPEG, "images")))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _hold(data):
    got = jpeg.decode_jpeg(data)
    want = imageio.imread(io.BytesIO(data))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def test_fixture_folder_holds_the_cases():
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(ARITH_DIR, "*.jpg")))
    assert names == sorted(ARITH)


@pytest.mark.parametrize("name", sorted(ARITH))
def test_committed_fixtures_decode_to_their_pixels(name):
    h, w, c, _, progressive, restart, dac = ARITH[name]
    path = os.path.join(ARITH_DIR, name + ".jpg")
    data = _read(path)
    assert (b"\xff\xca" if progressive else b"\xff\xc9") in data
    assert (b"\xff\xdd" in data) == bool(restart)
    got = jpeg.read_jpeg(path)
    np.testing.assert_array_equal(got, np.load(path[:-4] + ".npy"))
    np.testing.assert_array_equal(got, imageio.imread(path))
    assert jpeg.probe_jpeg(data) == (h, w, c)


def _segment(data, marker):
    """Offset of the first segment with ``marker`` and its body's length."""
    at = data.index(bytes([0xFF, marker]))
    return at, struct.unpack(">H", data[at + 2:at + 4])[0] - 2


def test_the_dac_fixture_holds_its_conditioning():
    data = _read(os.path.join(ARITH_DIR, "a420_q85_48x64_dac.jpg"))
    at, n = _segment(data, 0xCC)
    body = data[at + 4:at + 4 + n]
    # DC table 0: L 2, U 6; AC table 0: Kx 12 (and the chroma tables alike)
    assert body[:4] == bytes([0x00, 2 + 16 * 6, 0x10, 12])


@pytest.mark.parametrize("name,dac", [("a422_q75_37x29", (1, 2, 1)),
                                      ("ap420_q95_29x37", (0, 0, 40)),
                                      ("a420_q85_48x64_dac", (0, 1, 5))])
def test_rewritten_conditioning_decodes_as_imageio_decodes_it(name, dac):
    """Every DAC entry of a fixture rewritten to (L, U, Kx): the bits now
    drive other contexts, and both decoders read the same coefficients."""
    data = bytearray(_read(os.path.join(ARITH_DIR, name + ".jpg")))
    pos = 0
    while (pos := data.find(b"\xff\xcc", pos)) >= 0:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0] - 2
        for i in range(pos + 4, pos + 4 + n, 2):
            data[i + 1] = dac[0] + 16 * dac[1] if data[i] < 16 else dac[2]
        pos += 2
    got = _hold(bytes(data))
    assert not np.array_equal(got, np.load(os.path.join(ARITH_DIR, name + ".npy"))) \
        or dac == (0, 1, 5)


@pytest.mark.parametrize("name", ["a420_q95_29x37_restart", "ap444_q90_17x33"])
def test_exif_and_comment_segments_are_skipped(name):
    from PIL import Image
    data = _read(os.path.join(ARITH_DIR, name + ".jpg"))
    exif = Image.Exif()
    exif[0x0112] = 6
    blob = exif.tobytes()
    app1 = b"\xff\xe1" + struct.pack(">H", len(blob) + 8) + b"Exif\x00\x00" + blob
    com = b"\xff\xfe" + struct.pack(">H", 9) + b"a comment"
    got = _hold(data[:2] + app1 + com + data[2:])
    np.testing.assert_array_equal(got, np.load(os.path.join(ARITH_DIR, name + ".npy")))


@pytest.mark.parametrize("keep", [0.3, 0.7, 0.99])
def test_truncated_arithmetic_file_is_refused(keep):
    data = _read(os.path.join(ARITH_DIR, "ap420_q85_48x64_dac_restart.jpg"))
    with pytest.raises(ValueError, match="truncated|corrupt"):
        jpeg.decode_jpeg(data[:int(len(data) * keep)])


def test_the_arithmetic_capture_is_the_jpeg_captures_pixels():
    """Each image's coefficients are the Huffman file's, so it decodes to
    the same pixels: the port's decode of both, and imageio's."""
    assert sorted(os.listdir(os.path.join(LLFF_AJPEG, "images"))) == NAMES and len(NAMES) == 32
    assert np.array_equal(np.load(os.path.join(LLFF_AJPEG, "poses_bounds.npy")),
                          np.load(os.path.join(LLFF_JPEG, "poses_bounds.npy")))
    t = time.perf_counter()
    got = [jpeg.read_jpeg(os.path.join(LLFF_AJPEG, "images", n)) for n in NAMES]
    seconds = time.perf_counter() - t
    print(f"demo/llff_scene_ajpeg: 32 images {got[0].shape} decoded in {seconds:.2f} s of host "
          f"CPU ({1e3 * seconds / 32:.1f} ms an image)")
    for i, (n, img) in enumerate(zip(NAMES, got)):
        data = _read(os.path.join(LLFF_AJPEG, "images", n))
        assert (b"\xff\xca" if i % 2 else b"\xff\xc9") in data
        np.testing.assert_array_equal(img, jpeg.read_jpeg(os.path.join(LLFF_JPEG, "images", n)))
        np.testing.assert_array_equal(img, imageio.imread(os.path.join(LLFF_JPEG, "images", n)))


@pytest.mark.parametrize("factor", [1, 2])
def test_load_llff_data_on_the_arithmetic_capture_matches_jax(factor):
    got = t_llff.load_llff_data(LLFF_AJPEG, factor=factor, recenter=True, bd_factor=0.75)
    want = j_llff.load_llff_data(LLFF_AJPEG, factor=factor, recenter=True, bd_factor=0.75)
    assert got[0].shape == (32, 240 // factor, 320 // factor, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_conversion_of_the_arithmetic_capture_meets_the_pin(tmp_path):
    d = str(tmp_path / "scene")
    shutil.copytree(LLFF_AJPEG, d)
    _convert_port(d, 1)
    assert _jsons(d) == _jsons(PNG_SCENE)
    with open(PINNED) as f:
        pinned = json.load(f)
    mean, n = mean_psnr_vs_png(d)
    print(f"demo/llff_scene_ajpeg -factor 1: {mean:.6f} dB over {n} images (pinned "
          f"{pinned['mean_psnr_db']:.6f})")
    assert n == pinned["images"] and abs(mean - pinned["mean_psnr_db"]) <= pinned["bar_db"]
