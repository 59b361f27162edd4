"""Z-samplers of the render path.

Counterpart of ``adanerf_tpu/ops/samplers.py``: ``linearly_spaced_z``,
``perturb_z``, ``adaptive_select`` and its literal twin
``adaptive_select_reference``.
Thresholds apply to the oracle's raw logits (the cascade never sigmoids the
oracle output). Selection rule: keep at most ``max_samples`` bins with value
>= threshold, highest value first, ties to the lower bin; if no bin passes,
keep the argmax bin (lowest index on ties). Slots follow ascending bin order,
with ``inf`` z, 0 prob and False mask at the dead tail.
"""

from __future__ import annotations

import numpy as np
import torch


def linspace_midpoints(n_samples: int) -> np.ndarray:
    """t in (0,1): linspace(0,1,S+1)[:-1] + 0.5/S."""
    return (np.linspace(0.0, 1.0, n_samples + 1)[:-1] + 0.5 / n_samples).astype(np.float32)


def linearly_spaced_z(n_rays: int, z_near: float, z_far: float, n_samples: int,
                      device="cpu") -> torch.Tensor:
    """Deterministic LinearlySpacedZNearZFarNoDepthRange, (n_rays, n_samples)."""
    t = torch.as_tensor(linspace_midpoints(n_samples), device=device)
    z = z_near * (1.0 - t) + z_far * t
    return z.expand(n_rays, n_samples)


def perturb_z(z_vals: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Stratified jitter between sample midpoints; the uniform draws come
    from ``generator`` (on the device of ``z_vals``)."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    t_rand = torch.rand(z_vals.shape, generator=generator, device=z_vals.device)
    return lower + (upper - lower) * t_rand


def adaptive_select_reference(depth: torch.Tensor, max_samples: int,
                              threshold: float):
    """Literal form: stable descending sort prefix, threshold test, empty-ray
    argmax fallback, ascending re-sort. depth: (rays, disc).
    Returns (z_unit, z_probs, mask), each (rays, max_samples); no gradient
    reaches ``depth``."""
    depth = depth.detach()
    disc = depth.shape[-1]
    cell_size = 1.0 / disc
    vals, idx = torch.sort(depth, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :max_samples], idx[:, :max_samples]
    test = vals >= threshold

    z = torch.where(test, (idx.to(depth.dtype) + 0.5) * cell_size,
                    torch.zeros_like(vals))
    z_probs = torch.where(test, vals, torch.zeros_like(vals))

    empty = ~test[:, 0]
    z[:, 0] = torch.where(empty, (idx[:, 0].to(depth.dtype) + 0.5) * cell_size, z[:, 0])
    z_probs[:, 0] = torch.where(empty, vals[:, 0], z_probs[:, 0])

    z = torch.where(z == 0.0, torch.full_like(z, float("inf")), z)
    order = torch.argsort(z, dim=1, stable=True)
    z = torch.take_along_dim(z, order, dim=1)
    z_probs = torch.take_along_dim(z_probs, order, dim=1)
    return z, z_probs, torch.isfinite(z)


def select_keep(depth: torch.Tensor, max_samples: int, threshold: float) -> torch.Tensor:
    """(rays, disc) bool mask of the kept bins under the selection rule."""
    n_rays, disc = depth.shape
    bin_iota = torch.arange(disc, device=depth.device).expand(n_rays, disc)
    d_work = depth
    v_k = None
    for _ in range(max_samples):  # v_K: K-th largest, first-occurrence argmax
        v_k, idx = torch.max(d_work, dim=1)
        d_work = torch.where(bin_iota == idx[:, None],
                             torch.full_like(d_work, float("-inf")), d_work)
    above = depth > v_k[:, None]
    n_above = above.sum(dim=1)
    ties = depth == v_k[:, None]
    tie_rank = torch.cumsum(ties.to(torch.int32), dim=1)
    keep = above | (ties & (tie_rank <= (max_samples - n_above)[:, None]))
    keep = keep & (depth >= threshold)
    empty = ~keep.any(dim=1)
    am = torch.argmax(depth, dim=1)
    return keep | (empty[:, None] & (bin_iota == am[:, None]))


def adaptive_select(depth: torch.Tensor, max_samples: int, threshold: float):
    """Sort-free adaptive select with the semantics of
    ``adaptive_select_reference``: the kept bins are already in ascending
    order, so slot s holds the (s+1)-th kept bin. Carries no gradient to
    ``depth``, as the JAX version stops it."""
    depth = depth.detach()
    n_rays, disc = depth.shape
    cell_size = 1.0 / disc
    keep = select_keep(depth, max_samples, threshold)
    rowcum = torch.cumsum(keep.to(torch.int32), dim=1)
    n_per_ray = rowcum[:, -1]
    slot_iota = torch.arange(max_samples, device=depth.device)
    mask = slot_iota[None, :] < n_per_ray[:, None]
    # bin of slot s = number of bins whose running count is still <= s
    bin_of_slot = (rowcum[:, None, :] <= slot_iota[None, :, None]).sum(dim=2)
    bin_of_slot = torch.clamp(bin_of_slot, max=disc - 1)
    z_probs = torch.gather(depth, 1, bin_of_slot)
    z = torch.where(mask, (bin_of_slot.to(depth.dtype) + 0.5) * cell_size,
                    torch.full_like(z_probs, float("inf")))
    z_probs = torch.where(mask, z_probs, torch.zeros_like(z_probs))
    return z, z_probs, mask
