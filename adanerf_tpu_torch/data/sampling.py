"""Low-discrepancy pixel sampling.

Counterpart of ``adanerf_tpu/data/sampling.py`` (numpy, no native path): the
R-sequence ``val_i = (seed + alpha * (i+1)) mod 1``, evaluated for any index
window and wrapping at ``num_pregeneration`` (30M) like the reference's
pregenerated cache; ``floor(val * range * 0.99999)`` discretization, so the
pixel picks are the JAX package's for the same seed.
"""

from __future__ import annotations

import numpy as np


def phi(d: int) -> float:
    x = 2.0
    for _ in range(10):
        x = pow(1 + x, 1 / (d + 1))
    return x


class RSequence:
    """PreGeneratedRSequenceGenerator."""
    name = "PreGeneratedRSequenceGenerator"

    def __init__(self, dims=2, seed=0.5, num_pregeneration=30_000_000, **_):
        self.dims = dims
        self.seed = seed
        self.num_pregeneration = num_pregeneration
        g = phi(dims)
        self.alpha = np.array([pow(1 / g, j + 1) % 1 for j in range(dims)])
        self.offset_start = 0

    def _values(self, start: int, count: int) -> np.ndarray:
        idx = np.arange(start, start + count, dtype=np.float64)[:, None]
        return (self.seed + self.alpha[None, :] * (idx + 1)) % 1.0

    def get_discrete_subset(self, num_elements: int, minv=0, maxv=(400, 400)):
        """Next window of the sequence discretized into [minv, maxv) ints,
        wrapping at num_pregeneration."""
        offset_end = self.offset_start + num_elements
        if offset_end > self.num_pregeneration:
            offset_end = num_elements
            self.offset_start = 0
        vals = self._values(self.offset_start, num_elements).astype(np.float32)
        self.offset_start = offset_end
        value_range = np.asarray(maxv) - np.asarray(minv)
        return (np.floor(vals * value_range * 0.99999)).astype(np.int64) + np.asarray(minv)

    def set_offset(self, offset: int):
        self.offset_start = offset

    def pixel_indices(self, num: int, h: int, w: int) -> np.ndarray:
        """(num,) flat pixel indices in the y + h * x convention."""
        px = self.get_discrete_subset(num, 0, (h, w))
        return px[:, 0] + h * px[:, 1]


class UniformSequence(RSequence):
    """PreGeneratedUniformRandomSequenceGenerator."""
    name = "PreGeneratedUniformRandomSequenceGenerator"

    def __init__(self, dims=2, seed=0, num_pregeneration=30_000_000, **_):
        self.dims = dims
        self.num_pregeneration = num_pregeneration
        self.rng = np.random.default_rng(seed if isinstance(seed, int) else 0)
        self.pregen = self.rng.random((num_pregeneration, dims), dtype=np.float32)
        self.offset_start = 0

    def _values(self, start, count):
        return self.pregen[start:start + count]


def get_sequence_generator(name: str, **kwargs):
    if name == "PreGeneratedRSequenceGenerator":
        return RSequence(**kwargs)
    if name == "PreGeneratedUniformRandomSequenceGenerator":
        # the uniform generator allocates its values eagerly; cap at 1M
        # unless asked for more, as the JAX package does
        kwargs.setdefault("num_pregeneration", 1_000_000)
        return UniformSequence(**kwargs)
    raise ValueError(f"Unknown sample generator {name}")
