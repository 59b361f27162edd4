"""Progressive JPEG (SOF2) through the port's decoder
(adanerf_tpu_torch/data/jpeg.py) against imageio, the JAX package's
reader (PIL on libjpeg-turbo), on the CPU: files that PIL writes with
``progressive=True`` in the cases ``tests/test_torch_jpeg.py`` covers
(4:4:4, 4:2:2 and 4:2:0 at qualities 75 to 95, optimized tables,
greyscale, restart markers, an EXIF block; a 4:4:0 file from OpenCV),
the committed progressive fixtures (``tests/torch_fixtures/jpeg/
progressive``, which the card run holds the decoder to), a truncated
progressive file, and the hierarchical progressive processes, refused by
name as imageio refuses them (ROADMAP item 23). Every case decodes to
imageio's pixels exactly."""

import glob
import io
import os

import imageio.v2 as imageio
import numpy as np
import pytest

from adanerf_tpu_torch.data import jpeg

from make_progressive_fixtures import CASES, FIXTURES
from torch_jpeg_fixtures import encode, seeded_image

SIZES = [(1, 1), (17, 33), (37, 29), (64, 48)]
SAMPLINGS = {"444": 0, "422": 1, "420": 2}


def _hold(data):
    got = jpeg.decode_jpeg(data)
    want = imageio.imread(io.BytesIO(data))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [75, 90, 95])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_progressive_matches_imageio(size, quality, sampling):
    data = encode(seeded_image(*size, 3, seed=quality), quality=quality,
                  subsampling=SAMPLINGS[sampling], progressive=True)
    assert b"\xff\xc2" in data
    _hold(data)


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_optimized_tables_match_imageio(sampling):
    """Optimized Huffman tables: a table of each scan's own statistics,
    defined between the scans."""
    data = encode(seeded_image(37, 29, 3, seed=5), quality=85, subsampling=SAMPLINGS[sampling],
                  progressive=True, optimize=True)
    assert data.count(b"\xff\xc4") > 2
    _hold(data)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("restart", [("restart_marker_blocks", 1),
                                     ("restart_marker_blocks", 3),
                                     ("restart_marker_rows", 1)], ids=lambda r: f"{r[0]}{r[1]}")
def test_restart_intervals_match_imageio(size, restart):
    """Restart intervals inside every kind of scan: the DC predictions and
    the end-of-band runs start again at each."""
    data = encode(seeded_image(*size, 3, seed=1), quality=90, subsampling=2, progressive=True,
                  **dict([restart]))
    assert b"\xff\xdd" in data and b"\xff\xc2" in data
    _hold(data)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_greyscale_matches_imageio(size):
    data = encode(seeded_image(*size, 1, seed=2), quality=80, progressive=True)
    assert _hold(data).shape == size


def test_exif_block_is_skipped():
    data = encode(seeded_image(20, 30, 3, seed=3), quality=85, subsampling=2, exif=6,
                  progressive=True)
    assert b"Exif\x00\x00" in data
    assert _hold(data).shape == (20, 30, 3)


@pytest.mark.parametrize("size", [(23, 19), (8, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_440_from_opencv_matches_imageio(size):
    import cv2
    img = seeded_image(*size, 3, seed=4)
    ok, data = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90,
                                                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x121111,
                                                     cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert ok and b"\xff\xc2" in data.tobytes()
    _hold(data.tobytes())


def test_fixture_folder_holds_the_cases():
    names = sorted(os.path.splitext(os.path.basename(p))[0]
                   for p in glob.glob(os.path.join(FIXTURES, "*.jpg")))
    assert names == sorted(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_committed_fixtures_decode_to_their_pixels(name):
    path = os.path.join(FIXTURES, name + ".jpg")
    with open(path, "rb") as f:
        data = f.read()
    assert b"\xff\xc2" in data
    got = jpeg.read_jpeg(path)
    np.testing.assert_array_equal(got, np.load(os.path.join(FIXTURES, name + ".npy")))
    np.testing.assert_array_equal(got, imageio.imread(path))
    h, w, c = CASES[name][:3]
    assert jpeg.probe_jpeg(data) == (h, w, c)


@pytest.mark.parametrize("keep", [0.3, 0.7, 0.99])
def test_truncated_progressive_file_is_refused(keep):
    data = encode(seeded_image(37, 29, 3, seed=6), quality=90, subsampling=2, progressive=True)
    with pytest.raises(ValueError, match="truncated|corrupt"):
        jpeg.decode_jpeg(data[:int(len(data) * keep)])


@pytest.mark.parametrize("marker,words", [(0xCE, "arithmetic-coded differential progressive"),
                                          (0xC6, "differential progressive")])
def test_other_progressive_processes_are_refused_by_name(marker, words):
    """The progressive processes that imageio refuses too (hierarchical,
    Huffman or arithmetic-coded) name ROADMAP item 23; arithmetic-coded
    progressive files (SOF10) decode: tests/test_torch_jpeg_arith.py."""
    data = bytearray(encode(seeded_image(17, 33, 3), quality=90, progressive=True))
    data[data.index(b"\xff\xc2") + 1] = marker
    with pytest.raises(ValueError, match=f"{words}.*imageio.*item 23"):
        jpeg.decode_jpeg(bytes(data))
    with pytest.raises(ValueError, match=words):
        jpeg.probe_jpeg(bytes(data))
