"""Volume rendering core: alpha compositing (classic NeRF and adaptive
masked), the NDC warp, inverse-CDF sampling and the ray helpers.

Counterpart of ``adanerf_tpu/ops/raymarch.py``: ``raw2alpha``,
``nerf_raw2outputs``, ``adaptive_raw2outputs_masked``, ``ndc_rays``,
``sample_pdf``, ``rotate_ray_dirs`` and ``ray_sphere_offset``. Random draws
(``sample_pdf``'s uniforms, the raw noise) come from an explicit
``torch.Generator``, or are passed in.
"""

from __future__ import annotations

import torch


def raw2alpha(raw_sigma: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """1 - exp(-relu(sigma) * dist)."""
    return 1.0 - torch.exp(-torch.relu(raw_sigma) * dists)


def _composite_weights(alpha: torch.Tensor) -> torch.Tensor:
    """w_i = a_i * prod_{j<i} (1 - a_j + 1e-10)."""
    ones = torch.ones_like(alpha[..., :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1), dim=-1)[..., :-1]
    return alpha * trans


def nerf_raw2outputs(raw, z_vals, rays_d, raw_noise_std=0.0, white_bkgd=False,
                     depth=None, accumulation_mult=None, generator=None):
    """Classic NeRF compositing.

    raw: (rays, S, 4) network output; z_vals: (rays, S); rays_d: (rays, 3).
    ``depth`` / ``accumulation_mult`` are AdaNeRF's oracle premultiply
    (alpha or weights times the oracle value). Returns (rgb_map, disp_map,
    acc_map, weights, depth_map, alpha).
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.vector_norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0 and generator is not None:
        sigma = sigma + torch.randn(sigma.shape, generator=generator,
                                    device=sigma.device) * raw_noise_std

    alpha = raw2alpha(sigma, dists)
    if depth is not None and accumulation_mult == "alpha":
        alpha = alpha * depth

    weights = _composite_weights(alpha)
    if depth is not None and accumulation_mult == "weights":
        weights = weights * depth

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map, alpha


def adaptive_raw2outputs_masked(raw, z_vals, mask, depth=None,
                                accumulation_mult=None, white_bkgd=False):
    """AdaNeRF adaptive compositing in fixed-shape masked form.

    raw: (rays, S, 4) raw outputs at all slots; z_vals: (rays, S) (may hold
    inf at dead slots); mask: (rays, S) bool; depth: (rays, S) oracle values
    for the 'alpha' / 'weights' premultiply.
    Returns (rgb_map, disp_map, acc_map, weights, depth_map, alpha).
    """
    m = mask.to(raw.dtype)
    sigmoided = torch.sigmoid(raw) * m[..., None]
    z_restored = torch.where(mask, z_vals, torch.zeros_like(z_vals))

    alpha = sigmoided[..., 3]
    rgb = sigmoided[..., :3]
    if depth is not None and accumulation_mult == "alpha":
        alpha = alpha * depth

    weights = _composite_weights(alpha)
    if depth is not None and accumulation_mult == "weights":
        weights = weights * depth

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_restored, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map, alpha


def ndc_rays(H, W, focal, near, rays_o, rays_d):
    """Shift origins to the near plane and project into NDC."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2]
                                       - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2]
                                       - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def sample_pdf(bins, weights, n_samples, det=False, generator=None, u=None):
    """Inverse-CDF hierarchical sampling.

    bins: (rays, B+1) bin edges; weights: (rays, B); returns (rays,
    n_samples). The uniforms are ``u`` where given (rays, n_samples), else
    ``linspace(0, 1, n_samples)`` when ``det`` or without a generator, else
    drawn from ``generator``.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    shape = cdf.shape[:-1] + (n_samples,)
    if u is None:
        if det or generator is None:
            u = torch.linspace(0.0, 1.0, n_samples, device=cdf.device,
                               dtype=cdf.dtype).expand(shape)
        else:
            u = torch.rand(shape, generator=generator, device=cdf.device, dtype=cdf.dtype)
    u = u.to(cdf.dtype).contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def rotate_ray_dirs(rotations: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Camera-space dirs -> world-space dirs.

    rotations: (n_img, 3, 3); directions: (n_img, n_rays, 3);
    returns (n_img * n_rays, 3).
    """
    rd = torch.einsum('bij,bnj->bni', rotations, directions)
    return rd.reshape(-1, 3)


def ray_sphere_offset(dirs, origins, center, radius):
    """Distance along each ray to its exit from the view-cell sphere.

    dirs: (N, 3) unit dirs; origins: (N, 3); center: (3,); radius: float.
    Returns (N,) distances (the '+sqrt(delta)' root, clamped >= 0 inside).
    """
    omc = origins - center
    u_dot = torch.sum(omc * dirs, dim=-1)
    delta = u_dot ** 2 - (torch.sum(omc ** 2, dim=-1) - radius ** 2)
    return -u_dot + torch.sqrt(torch.clamp(delta, min=0.0))
