"""The arithmetic-coded, lossless and 12-bit JPEG files that the port's
decoder is held to, and two copies of the LLFF JPEG demo capture in the
arithmetic and lossless processes.

  python tests/make_jpeg_process_fixtures.py

compiles ``tests/jpeg_process_writer.c`` with ``gcc`` against the
libjpeg-turbo that PIL bundles (found through ``PIL.__file__``: the library
imageio decodes with; the system's ``jpeglib.h`` declares its API) and
rewrites, from files and seeds in the repo:

* ``tests/torch_fixtures/jpeg/arith/<name>.jpg`` and ``<name>.npy`` (the
  pixels ``imageio.v2.imread`` gives): ``ARITH`` below, PIL's Huffman files
  of small seeded images transcoded coefficient for coefficient to
  arithmetic coding, sequential (SOF9) and progressive (SOF10), 4:4:4,
  4:2:2, 4:2:0 and greyscale, with and without restart intervals, and with
  a DAC segment of non-default L, U and Kx;
* ``tests/torch_fixtures/jpeg/lossless/<name>.jpg`` and ``<name>.npy``:
  ``LOSSLESS`` below, seeded images as SOF3 at predictors 1-7, point
  transforms 0 and 2, greyscale and RGB, with and without restarts;
* ``tests/torch_fixtures/jpeg/refused/twelve_sof{1,3}.jpg``: 12-bit files
  (extended sequential and lossless), which imageio refuses, and
  ``two_components.jpg`` (2 components, colour space unknown), which
  Pillow refuses;
* ``tests/torch_fixtures/jpeg/layouts/<name>.jpg`` and ``<name>.npy``:
  ``LAYOUTS`` below, seeded images in the layouts of ROADMAP item 24:
  sampling factors of 3 and 4 (4:1:1, 4:1:0, 1x4, 3x1, 3x2, mixed
  ratios), 4 components (CMYK and YCCK, with and without an Adobe marker,
  and PIL's own CMYK file) and lossless frames with subsampling, through
  the sequential, progressive, arithmetic-coded and lossless processes;
* ``demo/llff_scene_ajpeg/``: ``demo/llff_scene_jpeg``'s 32 images
  transcoded, the even-numbered ones to SOF9 and the odd-numbered ones to
  SOF10 (each keeping its source's restart interval), so they decode to
  exactly the source's pixels;
* ``demo/llff_scene_ljpeg/``: the same 32 images' decoded pixels written as
  SOF3 RGB at predictors cycling 1-7 (every third with a restart every 8
  rows), so they decode to exactly those pixels;
* ``demo/llff_scene_411/``: the same 32 images' decoded pixels re-encoded
  at quality 95 and 4:1:1 (luma 4x1, chroma 1x1), and its pins
  ``tests/torch_fixtures/llff_411.json``: imageio's decode against the PNG
  capture's images, and the JAX package's ``convert_llff.py -factor 1`` of
  it against the PNG capture's conversion.

Each capture gets a copy of the scene's ``poses_bounds.npy``. The tests
read the committed files only.

  python tests/make_jpeg_process_fixtures.py --time

writes nothing in the repo: it times the port's decode (host CPU seconds)
of both captures' 320x240 images and of a 4032x3024 photo-sized image
(``tests/test_torch_jpeg.py``'s: PIL quality 95, 4:2:0) transcoded to SOF9
and SOF10 and its pixels written as SOF3 at predictors 1 and 7, each
decode checked against imageio's pixels.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jpeg_fixtures import encode, seeded_image  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tests", "jpeg_process_writer.c")
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")
ARITH_DIR = os.path.join(FIXTURES, "arith")
LOSSLESS_DIR = os.path.join(FIXTURES, "lossless")
REFUSED_DIR = os.path.join(FIXTURES, "refused")
LLFF_JPEG = os.path.join(ROOT, "demo", "llff_scene_jpeg")
LLFF_AJPEG = os.path.join(ROOT, "demo", "llff_scene_ajpeg")
LLFF_LJPEG = os.path.join(ROOT, "demo", "llff_scene_ljpeg")
LLFF_411 = os.path.join(ROOT, "demo", "llff_scene_411")
LAYOUTS_DIR = os.path.join(FIXTURES, "layouts")
PINNED_411 = os.path.join(ROOT, "tests", "torch_fixtures", "llff_411.json")

# name -> (height, width, channels, PIL's save options for the Huffman
# source, progressive, restart interval in MCUs, DAC (L, U, Kx))
ARITH = {
    "a444_q90_17x33": (17, 33, 3, dict(quality=90, subsampling=0), 0, 0, (0, 1, 5)),
    "a422_q75_37x29": (37, 29, 3, dict(quality=75, subsampling=1), 0, 0, (0, 1, 5)),
    "a420_q95_29x37_restart": (29, 37, 3, dict(quality=95, subsampling=2), 0, 2, (0, 1, 5)),
    "agrey_q80_31x13": (31, 13, 1, dict(quality=80), 0, 0, (0, 1, 5)),
    "agrey_q90_40x24_restart": (40, 24, 1, dict(quality=90), 0, 3, (0, 1, 5)),
    "a420_q85_48x64_dac": (48, 64, 3, dict(quality=85, subsampling=2), 0, 0, (2, 6, 12)),
    "ap444_q90_17x33": (17, 33, 3, dict(quality=90, subsampling=0), 1, 0, (0, 1, 5)),
    "ap422_q75_37x29_restart": (37, 29, 3, dict(quality=75, subsampling=1), 1, 1, (0, 1, 5)),
    "ap420_q95_29x37": (29, 37, 3, dict(quality=95, subsampling=2), 1, 0, (0, 1, 5)),
    "apgrey_q80_31x13_restart": (31, 13, 1, dict(quality=80), 1, 2, (0, 1, 5)),
    "ap420_q85_48x64_dac_restart": (48, 64, 3, dict(quality=85, subsampling=2), 1, 4,
                                    (1, 3, 3)),
}
# name -> (height, width, channels, predictor, point transform, restart rows)
LOSSLESS = {
    "l1_rgb_17x33": (17, 33, 3, 1, 0, 0),
    "l2_rgb_37x29_pt2": (37, 29, 3, 2, 2, 0),
    "l3_rgb_29x37_restart": (29, 37, 3, 3, 0, 3),
    "l4_rgb_31x13": (31, 13, 3, 4, 0, 0),
    "l5_rgb_24x40_pt2_restart": (24, 40, 3, 5, 2, 2),
    "l6_rgb_37x29": (37, 29, 3, 6, 0, 0),
    "l7_rgb_29x37_restart": (29, 37, 3, 7, 0, 4),
    "l6_rgb_20x30_pt2": (20, 30, 3, 6, 2, 0),
    "l1_grey_31x13_restart": (31, 13, 1, 1, 0, 1),
    "l4_grey_37x29_pt2": (37, 29, 1, 4, 2, 0),
    "l7_grey_17x33_pt2_restart": (17, 33, 1, 7, 2, 5),
    "l5_grey_1x1": (1, 1, 1, 5, 0, 0),
}
TWELVE = {"twelve_sof1": 0, "twelve_sof3": 1}
# name -> (height, width, channels, colour space, Adobe marker, sampling
# factors, quality, progressive, arithmetic, lossless predictor (0: DCT),
# restart MCU rows); 3 channels are RGB, 4 CMYK, as the writer reads them
LAYOUTS = {
    "y411_q90_29x37": (29, 37, 3, "ycc", 1, "41,11,11", 90, 0, 0, 0, 0),
    "y410_q85_37x29": (37, 29, 3, "ycc", 1, "42,11,11", 85, 0, 0, 0, 0),
    "y141_q90_33x17": (33, 17, 3, "ycc", 1, "14,11,11", 90, 0, 0, 0, 0),
    "y311_q80_29x37": (29, 37, 3, "ycc", 1, "31,11,11", 80, 0, 0, 0, 0),
    "y321_q90_37x29_restart": (37, 29, 3, "ycc", 1, "32,11,11", 90, 0, 0, 0, 1),
    "y421_q90_29x37": (29, 37, 3, "ycc", 1, "41,21,11", 90, 0, 0, 0, 0),
    "ymixed_q90_29x37": (29, 37, 3, "ycc", 1, "21,12,11", 90, 0, 0, 0, 0),
    "y411_q90_9x2": (9, 2, 3, "ycc", 1, "41,11,11", 90, 0, 0, 0, 0),
    "y411_q90_9x5": (9, 5, 3, "ycc", 1, "41,11,11", 90, 0, 0, 0, 0),
    "y411_q90_1x1": (1, 1, 3, "ycc", 1, "41,11,11", 90, 0, 0, 0, 0),
    "grey41_q90_29x37": (29, 37, 1, "grey", 1, "41", 90, 0, 0, 0, 0),
    "yp411_q90_29x37": (29, 37, 3, "ycc", 1, "41,11,11", 90, 1, 0, 0, 0),
    "yp141_q85_33x17_restart": (33, 17, 3, "ycc", 1, "14,11,11", 85, 1, 0, 0, 2),
    "ya411_q90_29x37": (29, 37, 3, "ycc", 1, "41,11,11", 90, 0, 1, 0, 0),
    "yap410_q90_37x29": (37, 29, 3, "ycc", 1, "42,11,11", 90, 1, 1, 0, 0),
    "cmyk_q90_17x33": (17, 33, 4, "cmyk", 1, "11,11,11,11", 90, 0, 0, 0, 0),
    "cmyk_noadobe_q90_17x33": (17, 33, 4, "cmyk", 0, "11,11,11,11", 90, 0, 0, 0, 0),
    "cmyk411_q85_29x37": (29, 37, 4, "cmyk", 1, "41,11,11,11", 85, 0, 0, 0, 0),
    "cmyka_q90_17x33": (17, 33, 4, "cmyk", 1, "21,11,11,21", 90, 0, 1, 0, 0),
    "ycck_q90_17x33": (17, 33, 4, "ycck", 1, "22,11,11,22", 90, 0, 0, 0, 0),
    "ycck_noadobe_q90_17x33": (17, 33, 4, "ycck", 0, "22,11,11,22", 90, 0, 0, 0, 0),
    "yccp411_q85_29x37": (29, 37, 4, "ycck", 1, "41,11,11,41", 85, 1, 0, 0, 0),
    "yccap_q90_37x29_restart": (37, 29, 4, "ycck", 1, "22,11,11,22", 90, 1, 1, 0, 1),
    "l1_rgb22_29x37": (29, 37, 3, "rgb", 1, "22,11,11", 100, 0, 0, 1, 0),
    "l3_rgb21_37x29_restart": (37, 29, 3, "rgb", 1, "21,11,11", 100, 0, 0, 3, 2),
    "l7_rgb41_29x37": (29, 37, 3, "rgb", 1, "41,11,11", 100, 0, 0, 7, 0),
    "l4_rgb12_33x17": (33, 17, 3, "rgb", 1, "12,11,11", 100, 0, 0, 4, 0),
    "l2_rgb_g22_29x37": (29, 37, 3, "rgb", 1, "11,22,11", 100, 0, 0, 2, 3),
    "l1_cmyk22_17x33": (17, 33, 4, "cmyk", 1, "22,11,11,22", 100, 0, 0, 1, 0),
}


def libjpeg() -> str:
    """The libjpeg-turbo shared library that PIL bundles."""
    import PIL
    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                                  "pillow.libs", "libjpeg*.so*"))
    if len(libs) != 1:
        raise SystemExit(f"expected one libjpeg in PIL's bundled libraries, found {libs}")
    return libs[0]


def build(tmp: str) -> str:
    lib = libjpeg()
    exe = os.path.join(tmp, "jpeg_process_writer")
    subprocess.run(["gcc", "-O1", "-Wall", "-o", exe, SOURCE, lib,
                    f"-Wl,-rpath,{os.path.dirname(lib)}"], check=True)
    return exe


def write_case(path: str, data: bytes):
    import imageio.v2 as imageio
    with open(path, "wb") as f:
        f.write(data)
    np.save(path[:-4] + ".npy", imageio.imread(path))


def arith(exe: str, tmp: str, source: bytes, progressive: int, restart: int, dac) -> bytes:
    src, dst = os.path.join(tmp, "src.jpg"), os.path.join(tmp, "dst.jpg")
    with open(src, "wb") as f:
        f.write(source)
    subprocess.run([exe, "arith", src, dst, str(progressive), str(restart),
                    *map(str, dac)], check=True)
    with open(dst, "rb") as f:
        return f.read()


def lossless(exe: str, tmp: str, img: np.ndarray, predictor: int, pt: int, rows: int) -> bytes:
    raw, dst = os.path.join(tmp, "src.raw"), os.path.join(tmp, "dst.jpg")
    np.ascontiguousarray(img).tofile(raw)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    subprocess.run([exe, "lossless", raw, dst, str(w), str(h), str(c), str(predictor),
                    str(pt), str(rows)], check=True)
    with open(dst, "rb") as f:
        return f.read()


def twelve(exe: str, tmp: str, img: np.ndarray, lossless_: int) -> bytes:
    raw, dst = os.path.join(tmp, "src.raw"), os.path.join(tmp, "dst.jpg")
    (img.astype("<u2") * 16).tofile(raw)
    subprocess.run([exe, "twelve", raw, dst, str(img.shape[1]), str(img.shape[0]), "3",
                    str(lossless_)], check=True)
    with open(dst, "rb") as f:
        return f.read()


def layout_image(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """A seeded image of 1-4 channels (a 4th from another seed)."""
    img = seeded_image(h, w, 3, seed)
    if c == 4:
        img = np.concatenate([img, seeded_image(h, w, 3, seed + 7)[..., 2:]], axis=-1)
    return img[..., 0] if c == 1 else np.ascontiguousarray(img[..., :c])


def layout(exe: str, tmp: str, img: np.ndarray, space: str, adobe: int, factors: str,
           quality: int, progressive: int, arith_: int, predictor: int, rows: int) -> bytes:
    raw, dst = os.path.join(tmp, "src.raw"), os.path.join(tmp, "dst.jpg")
    np.ascontiguousarray(img).tofile(raw)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    subprocess.run([exe, "layout", raw, dst, str(w), str(h), str(c), space, str(adobe), factors,
                    str(quality), str(progressive), str(arith_), str(predictor), str(rows)],
                   check=True)
    with open(dst, "rb") as f:
        return f.read()


def write_layouts(exe: str, tmp: str):
    import io

    from PIL import Image
    os.makedirs(LAYOUTS_DIR, exist_ok=True)
    for seed, (name, (h, w, c, *options)) in enumerate(sorted(LAYOUTS.items())):
        write_case(os.path.join(LAYOUTS_DIR, name + ".jpg"),
                   layout(exe, tmp, layout_image(h, w, c, seed + 100), *options))
    buf = io.BytesIO()  # PIL's own CMYK file (an Adobe marker, transform 0)
    Image.fromarray(layout_image(23, 19, 4, 99), "CMYK").save(buf, "JPEG", quality=90)
    write_case(os.path.join(LAYOUTS_DIR, "cmyk_pil_q90_23x19.jpg"), buf.getvalue())
    with open(os.path.join(REFUSED_DIR, "two_components.jpg"), "wb") as f:
        f.write(layout(exe, tmp, layout_image(9, 7, 2, 98), "unknown", 0, "11,11", 90, 0, 0, 0,
                       0))


def write_411_capture(exe: str, tmp: str):
    """``demo/llff_scene_411`` and its pins."""
    import imageio.v2 as imageio
    from make_progressive_fixtures import LLFF_PNG, converted_psnr, psnr
    shutil.rmtree(LLFF_411, ignore_errors=True)
    os.makedirs(os.path.join(LLFF_411, "images"))
    shutil.copy(os.path.join(LLFF_JPEG, "poses_bounds.npy"), LLFF_411)
    psnrs = []
    for path in sorted(glob.glob(os.path.join(LLFF_JPEG, "images", "*.jpg"))):
        out = os.path.join(LLFF_411, "images", os.path.basename(path))
        with open(out, "wb") as f:
            f.write(layout(exe, tmp, imageio.imread(path), "ycc", 1, "41,11,11", 95, 0, 0, 0, 0))
        png = os.path.join(LLFF_PNG, "images", os.path.basename(path)[:-4] + ".png")
        psnrs.append(psnr(imageio.imread(out), imageio.imread(png)[..., :3]))
    mean, n = converted_psnr(LLFF_411)
    with open(PINNED_411, "w") as f:
        json.dump({
            "what": "demo/llff_scene_411 (demo/llff_scene_jpeg's 32 images re-encoded at quality "
                    "95, 4:1:1, tests/make_jpeg_process_fixtures.py): decode_mean_psnr_db, the "
                    "mean PSNR (dB) of imageio's decode of the 32 images against demo/"
                    "llff_scene's PNG images; mean_psnr_db, the mean PSNR over the 36 split "
                    "images (train 28, val 4, test 4) of the JAX package's convert_llff.py "
                    "-factor 1 on it against demo/llff_scene's; tests/test_torch_jpeg_layouts.py "
                    "holds the port to both on the CPU and chip_smoke.py phase 23 on the card",
            "decode_mean_psnr_db": float(np.mean(psnrs)), "decoded_images": len(psnrs),
            "mean_psnr_db": mean, "images": n, "bar_db": 0.01}, f, indent=2)
        f.write("\n")


def write_fixtures(exe: str, tmp: str):
    for d in (ARITH_DIR, LOSSLESS_DIR, REFUSED_DIR):
        os.makedirs(d, exist_ok=True)
    for seed, (name, (h, w, c, options, prog, restart, dac)) in enumerate(sorted(ARITH.items())):
        source = encode(seeded_image(h, w, c, seed + 40), **options)
        write_case(os.path.join(ARITH_DIR, name + ".jpg"),
                   arith(exe, tmp, source, prog, restart, dac))
    for seed, (name, (h, w, c, pred, pt, rows)) in enumerate(sorted(LOSSLESS.items())):
        write_case(os.path.join(LOSSLESS_DIR, name + ".jpg"),
                   lossless(exe, tmp, seeded_image(h, w, c, seed + 60), pred, pt, rows))
    for name, lossless_ in TWELVE.items():
        with open(os.path.join(REFUSED_DIR, name + ".jpg"), "wb") as f:
            f.write(twelve(exe, tmp, seeded_image(9, 7, 3, 80), lossless_))


def write_captures(exe: str, tmp: str):
    import imageio.v2 as imageio
    for d in (LLFF_AJPEG, LLFF_LJPEG):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(os.path.join(d, "images"))
        shutil.copy(os.path.join(LLFF_JPEG, "poses_bounds.npy"), d)
    for i, path in enumerate(sorted(glob.glob(os.path.join(LLFF_JPEG, "images", "*.jpg")))):
        name = os.path.basename(path)
        with open(path, "rb") as f:
            source = f.read()
        with open(os.path.join(LLFF_AJPEG, "images", name), "wb") as f:
            f.write(arith(exe, tmp, source, i % 2, -1, (0, 1, 5)))
        with open(os.path.join(LLFF_LJPEG, "images", name), "wb") as f:
            f.write(lossless(exe, tmp, imageio.imread(path), i % 7 + 1, 0,
                             8 if i % 3 == 0 else 0))


def photo() -> np.ndarray:
    """``tests/test_torch_jpeg.py::test_a_photo_sized_file_matches_imageio``'s
    4032x3024 image: smooth structure, stripes and fine noise."""
    rng = np.random.default_rng(8)
    h, w = 3024, 4032
    coarse = rng.normal(128, 40, (h // 48 + 1, w // 48 + 1, 3))
    img = np.repeat(np.repeat(coarse, 48, axis=0), 48, axis=1)[:h, :w]
    img = img + 20 * np.sin(np.arange(w) / 7.0)[None, :, None] + rng.normal(0, 4, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def time_decodes(exe: str, tmp: str):
    import time

    import imageio.v2 as imageio
    sys.path.insert(0, ROOT)
    from adanerf_tpu_torch.data.jpeg import decode_jpeg, read_jpeg
    for capture in (LLFF_JPEG, LLFF_AJPEG, LLFF_LJPEG):
        paths = sorted(glob.glob(os.path.join(capture, "images", "*.jpg")))
        t = time.perf_counter()
        for p in paths:
            read_jpeg(p)
        seconds = time.perf_counter() - t
        print(f"{os.path.relpath(capture, ROOT)}: {len(paths)} images 320x240, "
              f"{1e3 * seconds / len(paths):.1f} ms an image", flush=True)
    img = photo()
    source = encode(img, quality=95, subsampling=2)
    huffman = imageio.imread(source)
    # each file's pixels: the Huffman source's decode (the same coefficients)
    # or the image itself (lossless)
    files = {"SOF0 (Huffman, for scale)": (source, huffman),
             "SOF9": (arith(exe, tmp, source, 0, 0, (0, 1, 5)), huffman),
             "SOF10": (arith(exe, tmp, source, 1, 0, (0, 1, 5)), huffman),
             "SOF3, predictor 1": (lossless(exe, tmp, img, 1, 0, 0), img),
             "SOF3, predictor 7": (lossless(exe, tmp, img, 7, 0, 0), img)}
    for label, (data, want) in files.items():
        t = time.perf_counter()
        got = decode_jpeg(data)
        seconds = time.perf_counter() - t
        try:  # PIL reads 64 KiB at a time, which libjpeg's arithmetic decoder cannot take
            read = "equal" if np.array_equal(imageio.imread(data), want) else "differs"
        except OSError as err:
            read = f"refuses it ({err})"
        print(f"4032x3024 {label}: {len(data) / 1e6:.2f} MB, decoded in {seconds:.2f} s, "
              f"its pixels: {np.array_equal(got, want)}; imageio {read}", flush=True)


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        exe = build(tmp)
        if sys.argv[1:] == ["--time"]:
            time_decodes(exe, tmp)
        else:
            write_fixtures(exe, tmp)
            write_captures(exe, tmp)
            write_layouts(exe, tmp)
            write_411_capture(exe, tmp)
