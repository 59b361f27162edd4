"""Scene constants of the feature pipeline.

Counterpart of ``SceneStatic`` in ``adanerf_tpu/pipeline/features.py``. The
feature sets of the training path wait for the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple


@dataclass(frozen=True)
class SceneStatic:
    """Per-scene constants every stage needs."""
    w: int
    h: int
    fov: float
    focal: float
    view_cell_center: Tuple[float, float, float]
    view_cell_radius: float
    depth_range: Tuple[float, float]
    depth_range_warped: Tuple[float, float]
    depth_transform: Any  # LogTransform / LinearTransform / NoneTransform
    depth_max: float
