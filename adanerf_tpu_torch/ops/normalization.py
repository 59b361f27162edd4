"""Coordinate normalizations applied to ray sample positions before encoding.

Counterpart of ``adanerf_tpu/ops/normalization.py``. ``center`` is a (3,)
tensor on the positions' device; ``max_depth`` a float. Note the lookup key
``None`` (an absent config entry) resolves to MaxDepth, while the string
``"None"`` is the identity.
"""

from __future__ import annotations

import math

import torch

from .depth_transforms import LogTransform


def normalization_none(x, center, max_depth):
    return x


def normalization_center(x, center, max_depth):
    return x - center


def normalization_max_depth(x, center, max_depth):
    return x / max_depth


def normalization_max_depth_centered(x, center, max_depth):
    return (x - center) / max_depth


def normalization_log_centered(x, center, max_depth):
    localized = x - center
    local = torch.linalg.vector_norm(localized, dim=-1)
    logd = LogTransform.from_world(local, [0.0, max_depth])
    return localized * (logd / local)[..., None]


def normalization_inverse_dist_centered(x, center, max_depth):
    localized = x - center
    local = torch.linalg.vector_norm(localized, dim=-1)
    return localized * (1.0 - 1.0 / (1.0 + local))[..., None]


def normalization_inverse_sqrt_dist_centered(x, center, max_depth):
    localized = x - center
    local = torch.sqrt(torch.linalg.vector_norm(localized, dim=-1))
    return localized / (math.sqrt(max_depth) * local[..., None])


_SWITCH = {
    None: normalization_max_depth,
    "None": normalization_none,
    "Centered": normalization_center,
    "MaxDepth": normalization_max_depth,
    "MaxDepthCentered": normalization_max_depth_centered,
    "LogCentered": normalization_log_centered,
    "InverseDistCentered": normalization_inverse_dist_centered,
    "InverseSqrtDistCentered": normalization_inverse_sqrt_dist_centered,
}


def get_normalization(name):
    return _SWITCH.get(name)
