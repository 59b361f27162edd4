"""Depth warps between normalized [0,1] depth and world-space depth.

Counterpart of ``adanerf_tpu/ops/depth_transforms.py``. ``depth_range`` is a
``(min, max)`` pair; the functions take torch tensors, numpy arrays or
Python floats.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else np.log(x)


class LogTransform:
    name = "log"

    @classmethod
    def from_world(cls, depth, depth_range):
        min_d, max_d = depth_range[0], depth_range[1]
        max_v = max_d - min_d
        d = depth - min_d
        d = _where(d <= 0, 0.001, d)
        return _log(d + 1.0) / math.log(max_v + 1.0)

    @classmethod
    def to_world(cls, depth, depth_range):
        min_d, max_d = depth_range[0], depth_range[1]
        max_v = max_d - min_d
        return (max_v + 1.0) ** depth - 1.0 + min_d


class LinearTransform:
    name = "linear"

    @classmethod
    def from_world(cls, depth, depth_range):
        return (depth - depth_range[0]) / (depth_range[1] - depth_range[0])

    @classmethod
    def to_world(cls, depth, depth_range):
        return depth * (depth_range[1] - depth_range[0]) + depth_range[0]


class NoneTransform:
    name = "none"

    @classmethod
    def from_world(cls, depth, depth_range):
        return depth

    @classmethod
    def to_world(cls, depth, depth_range):
        return depth


def get_depth_transform(name: str):
    """Config string -> transform class."""
    if name == "log":
        return LogTransform
    if name == "linear":
        return LinearTransform
    return NoneTransform
