"""The progressive JPEG files that the port's decoder is held to where
there is no imageio (the GPU machine), and a progressive JPEG copy of the
LLFF demo scene with its pinned readings.

  python tests/make_progressive_fixtures.py

rewrites, from files and seeds in the repo, with PIL and imageio (and the
JAX package's root ``convert_llff.py`` for the pinned conversion):

* ``tests/torch_fixtures/jpeg/progressive/<name>.jpg`` and ``<name>.npy``,
  the pixels ``imageio.v2.imread`` gives for it: ``CASES`` below, small
  seeded images of odd sizes in PIL's samplings, greyscale, restart
  markers, optimized tables and an EXIF block, all progressive (SOF2);
* ``demo/llff_scene_pjpeg/``: ``images/0000.jpg`` ... written from
  ``demo/llff_scene/images/*.png`` progressive at quality 90, 4:2:0, the
  odd-numbered ones with a restart interval of 4 MCUs, and a copy of the
  scene's ``poses_bounds.npy``;
* ``tests/torch_fixtures/llff_pjpeg.json``: imageio's decode of that
  capture against the PNG images (the mean PSNR of the 32 images), and the
  JAX package's ``convert_llff.py -factor 1`` of it against
  ``demo/llff_scene``'s split images (the mean PSNR of the 36), which
  ``tests/test_torch_llff_jpeg.py`` and ``chip_smoke.py`` phase 21 hold the
  port's decoder and conversion to.
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
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg", "progressive")
LLFF_PNG = os.path.join(ROOT, "demo", "llff_scene")
LLFF_PJPEG = os.path.join(ROOT, "demo", "llff_scene_pjpeg")
PINNED = os.path.join(ROOT, "tests", "torch_fixtures", "llff_pjpeg.json")
SPLITS = ("train", "val", "test")

# name -> (height, width, channels, PIL's save options besides progressive=True)
CASES = {
    "p444_q90_17x33": (17, 33, 3, dict(quality=90, subsampling=0)),
    "p422_q75_37x29_optimized": (37, 29, 3, dict(quality=75, subsampling=1, optimize=True)),
    "p420_q95_29x37_restart": (29, 37, 3, dict(quality=95, subsampling=2,
                                               restart_marker_blocks=2)),
    "p420_q80_48x64_restart_rows": (48, 64, 3, dict(quality=80, subsampling=2,
                                                    restart_marker_rows=1)),
    "pgrey_q80_31x13": (31, 13, 1, dict(quality=80)),
    "p420_q85_20x30_exif6": (20, 30, 3, dict(quality=85, subsampling=2, exif=6)),
}


def psnr(a, b):
    return float(10 * np.log10(1.0 / np.mean((a.astype(np.float64) / 255
                                              - b.astype(np.float64) / 255) ** 2)))


def write_fixtures():
    import imageio.v2 as imageio
    os.makedirs(FIXTURES, exist_ok=True)
    for seed, (name, (h, w, c, options)) in enumerate(sorted(CASES.items())):
        path = os.path.join(FIXTURES, name + ".jpg")
        with open(path, "wb") as f:
            f.write(encode(seeded_image(h, w, c, seed + 20), progressive=True, **options))
        np.save(os.path.join(FIXTURES, name + ".npy"), imageio.imread(path))


def write_llff_scene():
    """The progressive capture; returns the mean PSNR of imageio's decode
    of its 32 images against the PNG images."""
    import imageio.v2 as imageio
    os.makedirs(os.path.join(LLFF_PJPEG, "images"), exist_ok=True)
    shutil.copy(os.path.join(LLFF_PNG, "poses_bounds.npy"), LLFF_PJPEG)
    psnrs = []
    for i, png in enumerate(sorted(glob.glob(os.path.join(LLFF_PNG, "images", "*.png")))):
        options = dict(quality=90, subsampling=2, progressive=True)
        if i % 2:
            options["restart_marker_blocks"] = 4
        img = imageio.imread(png)[..., :3]
        path = os.path.join(LLFF_PJPEG, "images",
                            os.path.splitext(os.path.basename(png))[0] + ".jpg")
        with open(path, "wb") as f:
            f.write(encode(img, **options))
        psnrs.append(psnr(imageio.imread(path), img))
    return float(np.mean(psnrs)), len(psnrs)


def converted_psnr(capture: str = LLFF_PJPEG):
    """The JAX package's ``convert_llff.py -factor 1`` of a JPEG capture
    (the progressive one by default; imageio decodes it) against
    demo/llff_scene's split images: (mean PSNR, number of images)."""
    from PIL import Image
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, os.path.basename(capture))
        shutil.copytree(capture, d)
        subprocess.run([sys.executable, os.path.join(ROOT, "convert_llff.py"), "-dir", d,
                        "-factor", "1"], cwd=ROOT, check=True, capture_output=True,
                       env=dict(os.environ, ADANERF_PLATFORM="cpu", JAX_PLATFORMS="cpu"))
        psnrs = [psnr(np.asarray(Image.open(os.path.join(d, s, f)).convert("RGB")),
                      np.asarray(Image.open(os.path.join(LLFF_PNG, s, f)).convert("RGB")))
                 for s in SPLITS for f in sorted(os.listdir(os.path.join(LLFF_PNG, s)))]
    return float(np.mean(psnrs)), len(psnrs)


if __name__ == "__main__":
    write_fixtures()
    decode_mean, n_decoded = write_llff_scene()
    mean, n = converted_psnr()
    with open(PINNED, "w") as f:
        json.dump({
            "what": "demo/llff_scene_pjpeg (demo/llff_scene's 32 images as progressive JPEG, "
                    "tests/make_progressive_fixtures.py): decode_mean_psnr_db, the mean PSNR "
                    "(dB) of imageio's decode of the 32 images against their PNG sources; "
                    "mean_psnr_db, the mean PSNR over the 36 split images (train 28, val 4, "
                    "test 4) of the JAX package's convert_llff.py -factor 1 on it against "
                    "demo/llff_scene's; tests/test_torch_llff_jpeg.py holds the port to both "
                    "on the CPU and chip_smoke.py phase 21 on the card",
            "decode_mean_psnr_db": decode_mean, "decoded_images": n_decoded,
            "mean_psnr_db": mean, "images": n, "bar_db": 0.01}, f, indent=2)
        f.write("\n")
