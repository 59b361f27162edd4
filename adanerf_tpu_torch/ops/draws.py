"""The train step's random draws, on the whole batch or on a rank's slice.

The step seeds one generator a step and draws its uniforms (the samplers'
jitter, ``perturb_z``, ``sample_pdf``'s inverse-CDF draws) and its sigma
noise over the rays it holds, image-major: every draw's leading axis is
the batch's rays. A rank of the data-parallel step (``parallel/mesh.py``)
holds the same contiguous slice of every image's rays; to draw what the
one-process step draws for those rays it draws the whole batch's tensor
and keeps its slice (``RaySlice``), as the JAX package's global-view step
draws one key over the global batch.
"""

from __future__ import annotations

import torch


class RaySlice:
    """A generator standing for the whole batch on one rank: draws of
    ``n_images * world * per`` rays, of which rank ``rank`` keeps rays
    ``[rank * per, (rank + 1) * per)`` of every image."""

    def __init__(self, generator: torch.Generator, n_images: int, rank: int, world: int):
        self.generator = generator
        self.n_images, self.rank, self.world = n_images, rank, world

    def draw(self, fn, shape, device, dtype):
        shape = tuple(shape)
        if shape[0] % self.n_images:
            raise ValueError(f"a draw of shape {shape} does not split over "
                             f"{self.n_images} images")
        per = shape[0] // self.n_images
        full = fn((self.n_images, self.world, per) + shape[1:], generator=self.generator,
                  device=device, dtype=dtype)
        return full[:, self.rank].reshape(shape)


def rand(shape, generator, device, dtype=torch.float32) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` from a ``torch.Generator`` or a
    ``RaySlice``."""
    if isinstance(generator, RaySlice):
        return generator.draw(torch.rand, shape, device, dtype)
    return torch.rand(shape, generator=generator, device=device, dtype=dtype)


def randn(shape, generator, device, dtype=torch.float32) -> torch.Tensor:
    """Standard normals of ``shape``, as ``rand``."""
    if isinstance(generator, RaySlice):
        return generator.draw(torch.randn, shape, device, dtype)
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)
