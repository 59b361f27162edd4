"""OpenCV's ``INTER_AREA`` resize in numpy.

The JAX package resizes reference video frames and LLFF images with
``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)``; the machine that
runs the port on the GPU has no OpenCV. ``resize_area`` follows OpenCV's
three cases along each axis (``imgproc/src/resize.cpp``), with the scale
``src / dst`` of each axis:

* both scales >= 1 and integers: each output pixel is the mean of its
  ``sx x sy`` block, summed in float32 in OpenCV's order (so the result is
  OpenCV's to the bit: its generic loop adds the block in groups of four,
  its SIMD path for 2x2 blocks of 1 or 4 channels adds pairs);
* both scales >= 1 otherwise: each output pixel averages the source cells
  its footprint covers, a partly covered cell weighted by the covered
  fraction (``computeResizeAreaTab``);
* any scale < 1 (an upscale): not a box filter but a two-tap linear
  filter at ``sx = floor(d * scale)`` whose fractional weight is clipped,
  ``f = (d + 1) - (sx + 1) / scale``, ``f = 0 if f <= 0 else f - floor(f)``,
  the right tap clamped at the border.

In the other two cases each axis is a (dst, src) weight matrix with
OpenCV's float32 weights, applied in float64 and rounded to float32 once,
so the result is within a float32 rounding of OpenCV's own float32 sums.
"""

from __future__ import annotations

import math

import numpy as np

_EPS = np.finfo(np.float64).eps


def _area_fast(img: np.ndarray, sx: int, sy: int) -> np.ndarray:
    """Block means at integer scales, in float32 as OpenCV's
    ``resizeAreaFast`` sums them: the sy x sx block in row-major order,
    four values at a time, ``sum += ((v0 + v1) + v2) + v3``, then times
    ``1 / (sx * sy)``; 2x2 blocks of 1 or 4 channels go through its SIMD
    path, ``((v00 + v01) + (v10 + v11)) * 0.25``, which for one channel
    covers the first ``4 * floor(w / 4)`` outputs of each row."""
    h, w = img.shape[0] // sy, img.shape[1] // sx
    blocks = img[:h * sy, :w * sx].reshape(h, sy, w, sx, *img.shape[2:])
    vals = [blocks[:, j, :, i] for j in range(sy) for i in range(sx)]
    total = np.zeros_like(vals[0])
    k = 0
    while k <= len(vals) - 4:
        total = total + (((vals[k] + vals[k + 1]) + vals[k + 2]) + vals[k + 3])
        k += 4
    for v in vals[k:]:
        total = total + v
    out = total * np.float32(1.0 / (sx * sy))
    cn = img.shape[2] if img.ndim == 3 else 1
    if sx == sy == 2 and cn in (1, 4):
        v00, v01, v10, v11 = vals
        pairs = ((v00 + v01) + (v10 + v11)) * np.float32(0.25)
        covered = w if cn == 4 else 4 * (w // 4)
        out[:, :covered] = pairs[:, :covered]
    return out


def _area_weights(n_src: int, n_dst: int, scale: float) -> np.ndarray:
    """(n_dst, n_src) weights of OpenCV's area taps for scale >= 1."""
    w = np.zeros((n_dst, n_src), np.float64)
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = np.float32((s1 - f1) / cell)
        for s in range(s1, s2):
            w[d, s] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return w


def _linear_area_weights(n_src: int, n_dst: int, scale: float) -> np.ndarray:
    """(n_dst, n_src) weights of the two-tap filter OpenCV's INTER_AREA
    uses when the image is upscaled along some axis."""
    w = np.zeros((n_dst, n_src), np.float64)
    inv = 1.0 / scale
    for d in range(n_dst):
        s = math.floor(d * scale)
        f = float(np.float32((d + 1) - (s + 1) * inv))
        f = 0.0 if f <= 0 else float(np.float32(f - math.floor(f)))
        if s < 0:
            s, f = 0, 0.0
        if s >= n_src - 1:
            s, f = n_src - 1, 0.0
        w[d, s] += np.float32(1.0 - f)
        if f:
            w[d, s + 1] += np.float32(f)
    return w


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)``
    for a float32 (h, w) or (h, w, c) image."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    scale_x, scale_y = 1.0 / (width / w), 1.0 / (height / h)
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = int(round(scale_x)), int(round(scale_y))
        if abs(scale_x - ix) < _EPS and abs(scale_y - iy) < _EPS:
            return _area_fast(img, ix, iy)
    taps = _area_weights if scale_x >= 1 and scale_y >= 1 else _linear_area_weights
    wx, wy = taps(w, width, scale_x), taps(h, height, scale_y)
    out = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))
    out = np.tensordot(wx, out, axes=(1, 1)).swapaxes(0, 1)
    return out.astype(np.float32)
