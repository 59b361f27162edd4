"""Per-pixel camera-space ray directions for a pinhole camera.

Counterpart of ``adanerf_tpu/ops/raygen.py``: unit directions on a regular
pixel grid, y and z flipped (the camera looks down -z with +y up). Computed
once per frame size on the host with numpy.
"""

from __future__ import annotations

import numpy as np


def generate_ray_directions(w: int, h: int, fov: float, focal: float) -> np.ndarray:
    """Unit ray directions, shape (h, w, 3), y/z flipped."""
    x_dist = np.tan(fov / 2) * focal
    y_dist = x_dist * (h / w)
    x_dist_pp = x_dist / (w / 2)
    y_dist_pp = y_dist / (h / 2)

    start = np.array([-(x_dist - x_dist_pp / 2), -(y_dist - y_dist_pp / 2), focal])
    ray_d = np.broadcast_to(start, (h, w, 3)).copy()
    ray_d[:, :, 0] += x_dist_pp * np.arange(w)[None, :]
    ray_d[:, :, 1] += y_dist_pp * np.arange(h)[:, None]

    dirs = ray_d / np.linalg.norm(ray_d, axis=2, keepdims=True)
    dirs[:, :, 1] *= -1.0
    dirs[:, :, 2] *= -1.0
    return dirs
