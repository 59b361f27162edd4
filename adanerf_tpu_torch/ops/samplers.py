"""Z-samplers: where along each ray the shading network is evaluated.

Counterpart of ``adanerf_tpu/ops/samplers.py``, every sampler of it:
``linearly_spaced_z`` (+ ``_world``), ``linearly_spaced_from_depth``,
``from_depth_cells``, ``linearly_spaced_from_multi_depth``,
``unit_sphere_linear_outside_log``, ``from_iterative_sample_placement``,
``from_classified_depth``, ``perturb_z``, and ``adaptive_select`` with its
literal twin ``adaptive_select_reference``. A noisy sampler draws its
uniforms from ``generator`` (on the tensors' device), or takes them as
``u``, so a caller can feed it the draws of another implementation.

The adaptive select's thresholds apply to the oracle's raw logits (the
cascade never sigmoids the oracle output). Selection rule: keep at most
``max_samples`` bins with value >= threshold, highest value first, ties to
the lower bin; if no bin passes, keep the argmax bin (lowest index on
ties). Slots follow ascending bin order, with ``inf`` z, 0 prob and False
mask at the dead tail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .depth_transforms import LinearTransform, LogTransform
from .raymarch import sample_pdf


def linspace_midpoints(n_samples: int) -> np.ndarray:
    """t in (0,1): linspace(0,1,S+1)[:-1] + 0.5/S."""
    return (np.linspace(0.0, 1.0, n_samples + 1)[:-1] + 0.5 / n_samples).astype(np.float32)


def _uniform(shape, like: torch.Tensor, generator, u):
    """``u`` where given, else uniforms from ``generator``."""
    if u is not None:
        return torch.as_tensor(u, dtype=like.dtype, device=like.device).reshape(shape)
    return torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)


def _steps(n: int, last: float, device) -> torch.Tensor:
    """linspace(0, last, n) in fp32, as ``jnp.linspace`` gives it."""
    return torch.as_tensor(np.linspace(0.0, last, n, dtype=np.float32), device=device)


def linearly_spaced_z(n_rays: int, z_near: float, z_far: float, n_samples: int,
                      z_step: float = 0.0, noise_amplitude: float = 0.0, det: bool = True,
                      generator=None, device="cpu", u=None) -> torch.Tensor:
    """LinearlySpacedZNearZFarNoDepthRange, (n_rays, n_samples); not ``det``
    with a noise amplitude, each z moves by amplitude * z_step * (u - 0.5)."""
    t = torch.as_tensor(linspace_midpoints(n_samples), device=device)
    z = (z_near * (1.0 - t) + z_far * t).expand(n_rays, n_samples)
    if not det and noise_amplitude > 0.0 and (generator is not None or u is not None):
        noise = -z_step / 2 + z_step * _uniform(z.shape, z, generator, u)
        z = z + noise_amplitude * noise
    return z


def linearly_spaced_z_world(n_rays, z_near, z_far, n_samples, depth_range, depth_transform,
                            z_step=0.0, noise_amplitude=0.0, det=True, generator=None,
                            device="cpu", u=None):
    """LinearlySpacedZNearZFar: ``linearly_spaced_z`` warped to world depth."""
    z = linearly_spaced_z(n_rays, z_near, z_far, n_samples, z_step, noise_amplitude, det,
                          generator, device, u)
    return depth_transform.to_world(z, depth_range)


def linearly_spaced_from_depth(depth, n_samples, z_step, noise_amplitude=0.0,
                               depth_range=None, depth_transform=None, to_world=True,
                               generator=None, u=None):
    """LinearlySpacedFromDepth[NoDepthRange]: S samples z_step apart around
    each ray's normalized depth (rays, 1), starting floor(S/2) steps before
    it."""
    depth = depth.detach()
    if noise_amplitude > 0.0 and (generator is not None or u is not None):
        depth = depth + noise_amplitude * (
            -z_step / 2 + z_step * _uniform(depth.shape, depth, generator, u))
    z_near = depth - z_step * math.floor(n_samples / 2)
    steps = _steps(n_samples, z_step * (n_samples - 1), depth.device)
    z = (z_near[..., None] + steps).reshape(depth.shape[0], n_samples)
    return depth_transform.to_world(z, depth_range) if to_world else z


def from_depth_cells(depth, n_samples, z_step, disc=128, noise_amplitude=0.0,
                     depth_range=None, depth_transform=None, generator=None, u=None):
    """FromDepthCells: the depth discretized to its cell's centre first,
    then placed as ``linearly_spaced_from_depth``."""
    depth = depth.detach()
    depth_disc = (torch.floor(depth * disc) + 0.5) / disc
    if noise_amplitude > 0.0 and (generator is not None or u is not None):
        depth_disc = depth_disc + noise_amplitude * (
            -z_step / 2 + z_step * _uniform(depth.shape, depth, generator, u))
    z_near = depth_disc - z_step * math.floor(n_samples / 2)
    steps = _steps(n_samples, z_step * (n_samples - 1), depth.device)
    z = (z_near[..., None] + steps).reshape(depth.shape[0], n_samples)
    return depth_transform.to_world(z, depth_range)


def linearly_spaced_from_multi_depth(depth, n_samples, z_step, noise_amplitude=0.0,
                                     depth_range=None, depth_transform=None, generator=None,
                                     u=None):
    """LinearlySpacedFromMultiDepth: clusters of samples around several
    sorted reference depths, their starts pushed apart (right to left) so
    that clusters do not overlap."""
    sorted_depth = torch.clamp(torch.sort(depth, dim=-1).values, 0.0, 1.0)
    if noise_amplitude > 0.0 and (generator is not None or u is not None):
        sorted_depth = sorted_depth + noise_amplitude * (
            -z_step / 2 + z_step * _uniform(sorted_depth.shape, sorted_depth, generator, u))
    starting_points = depth.shape[-1]
    samples_per_point = (n_samples + starting_points - 1) // starting_points
    z_nears = sorted_depth - z_step * samples_per_point / 2
    min_dist = z_step * (samples_per_point + 1)
    cols = [z_nears[:, i] for i in range(starting_points)]
    for i in range(starting_points - 1):
        hi, lo = starting_points - i - 1, starting_points - i - 2
        cols[lo] = cols[lo] + torch.clamp(cols[hi] - cols[lo] - min_dist, max=0.0)
    z_nears = torch.stack(cols, dim=1)
    z_base = torch.repeat_interleave(z_nears, samples_per_point, dim=1)
    steps = _steps(samples_per_point, z_step * samples_per_point, depth.device)
    z = (z_base + steps.repeat(starting_points)[None]).reshape(
        depth.shape[0], starting_points * samples_per_point)
    return depth_transform.to_world(z, depth_range)


def unit_sphere_linear_outside_log(ray_origins, ray_directions, n_rays, z_near, z_far,
                                   n_samples, depth_range, **_):
    """UnitSphereLinearOutsideLog: half the samples linear inside the unit
    sphere, half logarithmic beyond its exit."""
    u_dot_o = torch.sum(ray_origins * ray_directions.reshape(-1, 3), dim=1)
    delta = u_dot_o ** 2 - (torch.sum(ray_origins ** 2, dim=-1) - 1.0)
    t_int = torch.maximum(-u_dot_o + torch.sqrt(delta), -u_dot_o - torch.sqrt(delta))
    half = n_samples // 2
    dev = ray_origins.device
    t_int = t_int[:, None].expand(n_rays, half)

    t_in = torch.as_tensor(linspace_midpoints(half), device=dev)
    t_in = (z_near * (1.0 - t_in) + z_far * t_in).expand(n_rays, half)
    z_inside = LinearTransform.to_world(t_in, [torch.full_like(t_in, depth_range[0]), t_int])

    t_out = (np.linspace(0.0 + 0.5 / half, 1.0, half + 1)[:-1] + 0.5 / half).astype(np.float32)
    t_out = (torch.as_tensor(t_out, device=dev) * z_far).expand(n_rays, half)
    z_outside = LogTransform.to_world(t_out, [t_int, torch.full_like(t_in, depth_range[1])])
    return torch.cat([z_inside, z_outside], dim=1)


def from_iterative_sample_placement(sample_placement, n_ray_samples, depth_range,
                                    depth_transform):
    """FromIterativeSamplePlacement: a (rays, disc) 0/1 mask of active depth
    cells -> the first ``n_ray_samples`` active cells' centres, ascending
    (``inf`` where a ray has fewer)."""
    disc = sample_placement.shape[-1]
    t_vals = torch.as_tensor(np.linspace(0.0, 1.0, disc + 1, dtype=np.float32)[:-1],
                             device=sample_placement.device) + (1.0 / disc) * 0.5
    cand = torch.where(sample_placement > 0, t_vals,
                       torch.full_like(t_vals, float("inf")))
    z = -torch.topk(-cand, n_ray_samples, dim=-1).values
    return depth_transform.to_world(z, depth_range)


def from_classified_depth(depth, n_samples, depth_range, depth_transform, det=True,
                          generator=None, transform=None, u=None):
    """FromClassifiedDepth: inverse-CDF samples of the oracle's per-bin
    profile (after ``transform``), the first and last of n + 2 dropped."""
    depth = depth.detach()
    if transform is not None:
        depth = transform(depth)
    disc = depth.shape[-1]
    mids = torch.as_tensor(np.linspace(0.0, 1.0, disc + 1, dtype=np.float32),
                           device=depth.device).expand(depth.shape[0], disc + 1)
    z = sample_pdf(mids, depth, n_samples + 2, det=det, generator=generator, u=u)
    return depth_transform.to_world(z[:, 1:-1].detach(), depth_range)


def perturb_z(z_vals: torch.Tensor, generator: torch.Generator = None,
              u=None) -> torch.Tensor:
    """Stratified jitter between sample midpoints; the uniform draws come
    from ``generator`` (on the device of ``z_vals``), or are ``u``."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    t_rand = _uniform(z_vals.shape, z_vals, generator, u)
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
