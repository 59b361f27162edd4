"""The port's PNG decoder and encoder (adanerf_tpu_torch/data/png.py)
against imageio, bit for bit: every training image of demo/mscene (RGB,
400x400, mostly Paeth-filtered rows), written RGBA and RGB images covering
all five row filters, the formats it refuses, and the encoder's files read
back by both decoders."""

import glob
import os
import zlib

import numpy as np
import pytest

import imageio.v2 as imageio

from adanerf_tpu_torch.data.png import read_png, read_pngs, unfilter, write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_PNGS = sorted(glob.glob(os.path.join(ROOT, "demo", "mscene", "train", "*.png")))


@pytest.fixture(scope="module")
def decoded():
    return dict(zip(TRAIN_PNGS, read_pngs(TRAIN_PNGS)))


def test_mscene_has_training_images():
    assert len(TRAIN_PNGS) == 36


@pytest.mark.parametrize("path", TRAIN_PNGS, ids=os.path.basename)
def test_mscene_train_png_matches_imageio(decoded, path):
    ref = imageio.imread(path)
    got = decoded[path]
    assert got.dtype == np.uint8 and got.shape == ref.shape == (400, 400, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("channels", [3, 4])
def test_written_png_round_trips(tmp_path, channels):
    img = np.random.default_rng(channels).integers(0, 256, (19, 23, channels), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(read_png(path), imageio.imread(path))


def _filter_row(kind, row, prev, bpp):
    """Encoder side of the five PNG filters, per byte (ints)."""
    out = []
    for i, v in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((v - pred) % 256)
    return out


def test_every_filter_type_unfilters():
    rng = np.random.default_rng(7)
    h, w, bpp = 10, 9, 3
    img = rng.integers(0, 256, (h, w, bpp), dtype=np.uint8)
    raw = []
    prev = [0] * (w * bpp)
    for r in range(h):
        row = [int(v) for v in img[r].reshape(-1)]
        kind = r % 5
        raw.append([kind] + _filter_row(kind, row, prev, bpp))
        prev = row
    got = unfilter(np.array(raw, np.uint8), bpp)
    np.testing.assert_array_equal(got, img)


def _png(width, height, depth, colour, interlace=0, filtering=0, bad_crc=False):
    import struct

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xffffffff)
    ihdr = struct.pack(">IIBBBBB", width, height, depth, colour, 0, filtering, interlace)
    data = zlib.compress(b"\0" * (height * (1 + width * 8)))
    idat = chunk(b"IDAT", data)
    if bad_crc:
        idat = idat[:-1] + bytes([idat[-1] ^ 1])
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + idat + chunk(b"IEND", b""))


# the refusals that remain now that every format the PNG specification
# allows decodes: (IHDR fields, a broken CRC, what the message names)
@pytest.mark.parametrize("depth,colour,interlace,words", [
    (16, 3, 0, "bit depth 16, colour type 3 (palette)"),
    (4, 2, 0, "bit depth 4, colour type 2 (RGB)"),
    (8, 2, 2, "interlace 2"),
    (8, 2, "crc", "the CRC of its 'IDAT' chunk does not match"),
])
def test_other_formats_raise_naming_them(tmp_path, depth, colour, interlace, words):
    path = tmp_path / "x.png"
    if interlace == "crc":
        path.write_bytes(_png(4, 3, depth, colour, bad_crc=True))
    else:
        path.write_bytes(_png(4, 3, depth, colour, interlace))
    with pytest.raises(ValueError, match="PNG") as err:
        read_png(str(path))
    assert words in str(err.value)


@pytest.mark.parametrize("shape", [(19, 23, 3), (1, 1, 3), (40, 7, 4)])
def test_write_png_round_trips_and_imageio_reads_it(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "out.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(imageio.imread(path), img)


def test_write_png_re_encodes_a_scene_image(tmp_path):
    img = imageio.imread(TRAIN_PNGS[0])
    path = str(tmp_path / "again.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(imageio.imread(path), img)


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 3), np.float32), np.zeros((4, 4), np.uint8),
                                 np.zeros((4, 4, 2), np.uint8)])
def test_write_png_refuses_other_pixels(tmp_path, bad):
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "x.png"), bad)
