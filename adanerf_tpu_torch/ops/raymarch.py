"""Ray helpers and adaptive compositing for the render path.

Counterpart of the render-path functions of ``adanerf_tpu/ops/raymarch.py``:
``rotate_ray_dirs``, ``ray_sphere_offset``, ``ndc_rays`` and
``adaptive_raw2outputs_masked``. The training-side functions
(``nerf_raw2outputs``, ``sample_pdf``) wait for the training slice.
"""

from __future__ import annotations

import torch


def _composite_weights(alpha: torch.Tensor) -> torch.Tensor:
    """w_i = a_i * prod_{j<i} (1 - a_j + 1e-10)."""
    ones = torch.ones_like(alpha[..., :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=-1), dim=-1)[..., :-1]
    return alpha * trans


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
