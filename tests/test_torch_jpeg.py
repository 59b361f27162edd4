"""The port's JPEG decoder (adanerf_tpu_torch/data/jpeg.py) against
imageio, the JAX package's reader (PIL on libjpeg-turbo), on the CPU:

* files PIL writes in ``tmp_path``: 4:4:4, 4:2:2 and 4:2:0 at quality 50
  and 95, optimized Huffman tables on and off, restart markers, sizes 1x1,
  17x33 and 37x29, greyscale, an EXIF block with an orientation; a 4:4:0
  file that OpenCV writes. The bar is imageio's pixels, or at most 1
  level on at most 0.1% of them (the decoder follows libjpeg-turbo's
  integer IDCT, fancy upsampling and colour tables, so it reads 0);
* the committed fixtures (``tests/torch_fixtures/jpeg``, which the card
  run holds the decoder to) decode to their imageio pixels;
* a 4032x3024 4:2:0 quality-95 photo-sized file (made in ``tmp_path``)
  decodes to imageio's pixels; its host CPU time is printed;
* progressive, arithmetic-coded, lossless and 12-bit files, and truncated
  ones, are refused by name; ``png.read_image`` tells PNG from JPEG by
  the signature and ``png.check_image`` refuses from the headers alone."""

import glob
import io
import os
import time

import imageio.v2 as imageio
import numpy as np
import pytest

from adanerf_tpu_torch.data import jpeg
from adanerf_tpu_torch.data.png import check_image, read_image, write_png

from torch_jpeg_fixtures import CASES, FIXTURES, encode, seeded_image

SIZES = [(1, 1), (17, 33), (37, 29)]
SAMPLINGS = {"444": 0, "422": 1, "420": 2}


def _hold(got, path_or_bytes):
    ref = imageio.imread(path_or_bytes if isinstance(path_or_bytes, str)
                         else io.BytesIO(path_or_bytes))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    d = np.abs(got.astype(np.int16) - ref)
    n_off = int((d > 0).sum())
    print(f"{got.shape}: {n_off} of {d.size} values differ, max {int(d.max())}")
    assert d.max() <= 1 and n_off <= d.size // 1000


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("optimize", [False, True], ids=["std", "optimized"])
def test_decoder_matches_imageio(size, quality, sampling, optimize):
    data = encode(seeded_image(*size, 3, seed=quality), quality=quality,
                  subsampling=SAMPLINGS[sampling], optimize=optimize)
    _hold(jpeg.decode_jpeg(data), data)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("restart", [("restart_marker_blocks", 1),
                                     ("restart_marker_blocks", 3),
                                     ("restart_marker_rows", 1)], ids=lambda r: f"{r[0]}{r[1]}")
def test_restart_markers_match_imageio(size, restart):
    data = encode(seeded_image(*size, 3, seed=1), quality=90, subsampling=2,
                  **dict([restart]))
    assert b"\xff\xdd" in data  # a DRI segment
    _hold(jpeg.decode_jpeg(data), data)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 95])
def test_greyscale_matches_imageio(size, quality):
    data = encode(seeded_image(*size, 1, seed=2), quality=quality)
    got = jpeg.decode_jpeg(data)
    assert got.shape == size
    _hold(got, data)


@pytest.mark.parametrize("orientation", [1, 6, 8])
def test_exif_block_is_skipped_and_no_orientation_applied(orientation):
    """As imageio: an orientation-6 20x30 file reads as (20, 30, 3)."""
    data = encode(seeded_image(20, 30, 3, seed=3), quality=85, subsampling=2,
                  exif=orientation)
    assert b"Exif\x00\x00" in data
    got = jpeg.decode_jpeg(data)
    assert got.shape == (20, 30, 3)
    _hold(got, data)


@pytest.mark.parametrize("size", [(23, 19), (8, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_440_from_opencv_matches_imageio(size):
    data = encode(seeded_image(*size, 3, seed=4), "cv2", quality=90, sampling=0x121111)
    _hold(jpeg.decode_jpeg(data), data)


@pytest.mark.parametrize("name", sorted(CASES))
def test_committed_fixtures_decode_to_their_pixels(name):
    path = os.path.join(FIXTURES, name + ".jpg")
    got = jpeg.read_jpeg(path)
    np.testing.assert_array_equal(got, np.load(os.path.join(FIXTURES, name + ".npy")))
    _hold(got, path)


def test_fixture_folder_holds_the_cases():
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(FIXTURES, "*.jpg")))
    assert names == sorted(CASES)


def _sof(data):
    """Offset of the baseline frame header's marker byte (FF C0)."""
    return data.index(b"\xff\xc0") + 1


@pytest.mark.parametrize("marker,words", [(0xC3, "lossless"), (0xC9, "arithmetic"),
                                          (0xC7, "lossless"), (0xCA, "arithmetic")])
def test_other_processes_are_refused_by_name(marker, words):
    data = bytearray(encode(seeded_image(17, 33, 3), quality=90))
    data[_sof(data)] = marker
    with pytest.raises(ValueError, match=f"{words}.*item 21"):
        jpeg.decode_jpeg(bytes(data))
    with pytest.raises(ValueError, match=words):
        jpeg.probe_jpeg(bytes(data))


def test_progressive_is_refused_by_name():
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(seeded_image(37, 29, 3)).save(buf, "JPEG", progressive=True)
    with pytest.raises(ValueError, match="progressive.*imageio.*item 21"):
        jpeg.decode_jpeg(buf.getvalue())


def test_12_bit_samples_are_refused_by_name():
    data = bytearray(encode(seeded_image(17, 33, 3), quality=90))
    at = _sof(data)
    data[at] = 0xC1  # extended sequential, which allows 12-bit samples
    data[at + 3] = 12  # P, after the marker and the segment length
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode_jpeg(bytes(data))


@pytest.mark.parametrize("keep", [0.3, 0.7, 0.99])
def test_truncated_files_are_refused_by_name(keep):
    data = encode(seeded_image(37, 29, 3, seed=5), quality=95, subsampling=2)
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(data[:int(len(data) * keep)])


def test_extended_sequential_header_decodes_as_baseline():
    """SOF1 (extended sequential, 8-bit) differs from SOF0 only in what
    tables it may hold."""
    data = bytearray(encode(seeded_image(17, 33, 3, seed=6), quality=80))
    data[_sof(data)] = 0xC1
    np.testing.assert_array_equal(jpeg.decode_jpeg(bytes(data)),
                                  imageio.imread(io.BytesIO(encode(
                                      seeded_image(17, 33, 3, seed=6), quality=80))))


def test_read_image_dispatches_on_the_signature(tmp_path):
    img = seeded_image(9, 11, 3, seed=7)
    jpg, png, odd = tmp_path / "a.png", tmp_path / "b.jpg", tmp_path / "c.jpg"
    jpg.write_bytes(encode(img, quality=90))  # a JPEG named .png
    write_png(str(png), img)  # a PNG named .jpg
    odd.write_bytes(b"GIF89a" + bytes(32))
    _hold(read_image(str(jpg)), str(jpg))
    np.testing.assert_array_equal(read_image(str(png)), img)
    for f in (jpg, png):
        check_image(str(f))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        read_image(str(odd))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        check_image(str(odd))


def test_idct_of_a_dc_block_is_flat():
    coefs = np.zeros((1, 64), np.int16)
    coefs[0, 0] = 16  # x quant 8 = 128: a flat block 128 / 8 = 16 levels above 128
    out = jpeg.idct_islow(coefs, np.full(64, 8))
    assert out.shape == (1, 8, 8) and (out == 144).all()


def test_a_photo_sized_file_matches_imageio(tmp_path):
    """A 12-megapixel capture's size: smooth structure, stripes and fine
    noise at quality 95, 4:2:0. Prints the decode's host time."""
    rng = np.random.default_rng(8)
    h, w = 3024, 4032
    coarse = rng.normal(128, 40, (h // 48 + 1, w // 48 + 1, 3))
    img = np.repeat(np.repeat(coarse, 48, axis=0), 48, axis=1)[:h, :w]
    img = img + 20 * np.sin(np.arange(w) / 7.0)[None, :, None] + rng.normal(0, 4, (h, w, 3))
    path = str(tmp_path / "photo.jpg")
    with open(path, "wb") as f:
        f.write(encode(np.clip(img, 0, 255).astype(np.uint8), quality=95, subsampling=2))
    t = time.perf_counter()
    got = jpeg.read_jpeg(path)
    seconds = time.perf_counter() - t
    print(f"{os.path.getsize(path)} bytes, 4032x3024 4:2:0 q95: decoded in {seconds:.2f} s "
          "(host CPU)")
    _hold(got, path)
