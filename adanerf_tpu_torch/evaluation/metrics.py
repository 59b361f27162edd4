"""Basic image quality metrics: a copy of
``adanerf_tpu/evaluation/metrics.py`` (numpy, float64)."""

from __future__ import annotations

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10 * np.log10(max_val ** 2 / m))
