"""Image output helpers: single-channel tiling, the multi-depth top-3-argmax
view, clipping, and PNG writing without matplotlib.

Counterpart of ``adanerf_tpu/utils/saveimage.py``. The JAX package writes
through ``matplotlib.pyplot.imsave``, which turns an (h, w, 3) float image
into RGBA bytes as ``(x * 255).astype(uint8)`` in the image's own dtype
(truncation, alpha 255); ``save_img`` writes those bytes through
``data/png.py::write_png``, so the decoded pixels are the same.
"""

from __future__ import annotations

import numpy as np

from ..data.png import write_png


class Dim:
    """An image's height and width, as ``transform_img`` reads them."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w


def transform_img(img, dim):
    """Normalize an arbitrary network output into an (h, w, 3) image."""
    img = np.asarray(img, dtype=np.float32)

    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)

    if img.shape[-1] < 3:
        new_img = np.zeros(img.shape[:-1] + (3,), np.float32)
        new_img[..., :img.shape[-1]] = img
        img = new_img

    if img.shape[-1] == dim.h * dim.w:
        step = 1.0 / (img.max() + 1)
        img = 0.5 * step + img * step
        img = np.repeat(img[:, np.newaxis], 3, axis=1)

    # multi-depth (oracle bins) to a top-3-argmax RGB visualization
    if img.shape[-1] > 4:
        step = 1.0 / img.shape[-1]
        ids = np.argsort(img)[..., -3:]
        r = range(dim.h * dim.w)
        new_img = np.zeros((dim.h * dim.w, 3), np.float32)
        min_val = np.amin(img)
        for i in range(3):
            mask = img[r, ids[:, i]] > min_val
            new_img[mask, i] = 0.5 * step + ids[mask, i] * step
        img = new_img

    return np.clip(img.reshape(dim.h, dim.w, -1)[:, :, :3], 0.0, 1.0)


def to_rgba8(img) -> np.ndarray:
    """An (h, w, 3) or (h, w, 4) float image in [0, 1] as the RGBA bytes
    ``pyplot.imsave`` writes: ``(x * 255)`` in the image's dtype, truncated;
    alpha 255 where the image has none; a pixel with a NaN is (0, 0, 0, 0)."""
    img = np.asarray(img)
    if img.dtype.kind != "f":
        img = img.astype(np.float32)
    if img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError(f"save_img takes an (h, w, 3|4) image, not {img.shape}")
    rgba = np.empty(img.shape[:2] + (4,), img.dtype)
    rgba[..., :img.shape[-1]] = img
    if img.shape[-1] == 3:
        rgba[..., 3] = 1.0
    rgba[np.isnan(img).any(axis=-1)] = 0.0
    if rgba.max() > 1 or rgba.min() < 0:
        raise ValueError("Floating point image RGB values must be in the 0..1 range.")
    return (rgba * 255).astype(np.uint8)


def save_img(img, dim, path, transform=True):
    if path is None:
        return
    if transform:
        img = transform_img(img, dim)
    write_png(path, to_rgba8(img))
