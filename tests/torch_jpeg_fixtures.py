"""The JPEG files that the port's decoder is held to where there is no
imageio (the GPU machine), and the JPEG copy of the LLFF demo scene.

  python tests/torch_jpeg_fixtures.py

rewrites both from files and seeds in the repo, with PIL (and OpenCV for
the 4:4:0 file, which PIL does not write), and imageio for the pixels:

* ``tests/torch_fixtures/jpeg/<name>.jpg`` and ``<name>.npy``, the pixels
  ``imageio.v2.imread`` gives for it: ``CASES`` below, small seeded images
  of odd sizes in every sampling the decoder takes, greyscale, restart
  markers and an EXIF block;
* ``demo/llff_scene_jpeg/``: ``images/0000.jpg`` ... written from
  ``demo/llff_scene/images/*.png`` at quality 95, 4:2:0, the odd-numbered
  ones with a restart interval of 4 MCUs, and a copy of the scene's
  ``poses_bounds.npy``.
"""

from __future__ import annotations

import glob
import io
import os
import shutil

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")
LLFF_PNG = os.path.join(ROOT, "demo", "llff_scene")
LLFF_JPEG = os.path.join(ROOT, "demo", "llff_scene_jpeg")

# name -> (height, width, channels, writer, its options)
CASES = {
    "rgb444_q90_17x33": (17, 33, 3, "pil", dict(quality=90, subsampling=0)),
    "rgb422_q75_37x29_optimized": (37, 29, 3, "pil", dict(quality=75, subsampling=1,
                                                          optimize=True)),
    "rgb420_q95_29x37_restart": (29, 37, 3, "pil", dict(quality=95, subsampling=2,
                                                        restart_marker_blocks=2)),
    "rgb440_q90_23x19": (23, 19, 3, "cv2", dict(quality=90, sampling=0x121111)),
    "grey_q80_31x13": (31, 13, 1, "pil", dict(quality=80)),
    "rgb420_q85_20x30_exif6": (20, 30, 3, "pil", dict(quality=85, subsampling=2, exif=6)),
}


def seeded_image(h: int, w: int, channels: int, seed: int = 0) -> np.ndarray:
    """Gradients plus seeded noise, (h, w, 3) or (h, w) uint8."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                     (xx + yy) * 128 / max(h + w - 2, 1)], axis=-1)
    img = np.clip(base + np.random.default_rng(seed).normal(0, 30, base.shape), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def encode(img: np.ndarray, writer: str = "pil", **options) -> bytes:
    """JPEG bytes of ``img``: PIL's ``save`` with ``options`` (``exif=N``
    adds an EXIF block with orientation N), or OpenCV's ``imencode`` with
    its quality and sampling-factor flags."""
    if writer == "cv2":
        import cv2
        ok, data = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img,
                                [cv2.IMWRITE_JPEG_QUALITY, options["quality"],
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, options["sampling"]])
        assert ok
        return data.tobytes()
    from PIL import Image
    options = dict(options)
    if "exif" in options:
        exif = Image.Exif()
        exif[0x0112] = options["exif"]
        options["exif"] = exif.tobytes()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **options)
    return buf.getvalue()


def write_fixtures():
    import imageio.v2 as imageio
    os.makedirs(FIXTURES, exist_ok=True)
    for seed, (name, (h, w, c, writer, options)) in enumerate(sorted(CASES.items())):
        path = os.path.join(FIXTURES, name + ".jpg")
        with open(path, "wb") as f:
            f.write(encode(seeded_image(h, w, c, seed), writer, **options))
        np.save(os.path.join(FIXTURES, name + ".npy"), imageio.imread(path))


def write_llff_scene():
    import imageio.v2 as imageio
    os.makedirs(os.path.join(LLFF_JPEG, "images"), exist_ok=True)
    shutil.copy(os.path.join(LLFF_PNG, "poses_bounds.npy"), LLFF_JPEG)
    for i, png in enumerate(sorted(glob.glob(os.path.join(LLFF_PNG, "images", "*.png")))):
        options = dict(quality=95, subsampling=2)
        if i % 2:
            options["restart_marker_blocks"] = 4
        name = os.path.splitext(os.path.basename(png))[0] + ".jpg"
        with open(os.path.join(LLFF_JPEG, "images", name), "wb") as f:
            f.write(encode(imageio.imread(png)[..., :3], **options))


if __name__ == "__main__":
    write_fixtures()
    write_llff_scene()
