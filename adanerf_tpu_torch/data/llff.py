"""LLFF (Local Light Field Fusion) forward-facing scene loading.

Counterpart of ``adanerf_tpu/data/llff.py``: read ``poses_bounds.npy``
(per-image 3x5 [R|t|hwf] and near/far bounds), downsample the images by
``factor`` where no ``images_{factor}/`` folder holds them already
(``utils/resize.py::resize_area``, OpenCV's ``INTER_AREA``, as the JAX
package resizes with cv2), recenter the pose cloud, rescale by the near
bound, and generate the spiral render path. PNG and JPEG images
(a capture's full-size ``images/`` are JPEG) are decoded with the port's
own decoders (``png.py::read_image``), as the JAX package reads them with
imageio.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.resize import resize_area
from .png import read_image


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], axis=1)


def recenter_poses(poses):
    poses_ = poses.copy()
    bottom = np.array([[0, 0, 0, 1.0]])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], axis=0)
    hom = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], (poses.shape[0], 1, 1))], axis=1)
    fixed = np.linalg.inv(c2w) @ hom
    poses_[:, :3, :4] = fixed[:, :3, :4]
    return poses_


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, N):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        render_poses.append(np.concatenate([_viewmatrix(z, up, c), hwf], axis=1))
    return np.array(render_poses)


def _load_images(basedir, factor):
    img_dir = os.path.join(basedir, "images")
    if factor is not None and factor > 1 and \
            os.path.exists(os.path.join(basedir, f"images_{factor}")):
        img_dir = os.path.join(basedir, f"images_{factor}")
        factor_applied = True
    else:
        factor_applied = factor is None or factor <= 1
    files = sorted(f for f in os.listdir(img_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    imgs = []
    for f in files:
        img = read_image(os.path.join(img_dir, f)).astype(np.float32) / 255.0
        if not factor_applied:
            img = resize_area(img, img.shape[1] // factor, img.shape[0] // factor)
        imgs.append(img[..., :3])
    return np.stack(imgs)


def load_llff_data(basedir, factor=8, recenter=True, bd_factor=0.75,
                   spherify=False, path_zflat=False):
    """The standard LLFF loader.

    Returns (images, poses(3x5), bds, render_poses, i_test)."""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    images = _load_images(basedir, factor)
    actual_factor = poses[0, 4, 0] / images.shape[1]  # original H / loaded H
    poses[:2, 4, :] = np.array(images.shape[1:3]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] / actual_factor

    # column reorder: [down right back] -> [right up back]
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], axis=1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = recenter_poses(poses)

    c2w = poses_avg(poses)
    up = _normalize(poses[:, :3, 1].sum(0))

    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    mean_dz = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    focal = mean_dz
    zdelta = close_depth * 0.2
    tt = poses[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0)
    n_views, n_rots = 120, 2
    if path_zflat:
        zloc = -close_depth * 0.1
        c2w = c2w.copy()
        c2w[:3, 3] = c2w[:3, 3] + zloc * c2w[:3, 2]
        rads[2] = 0.0
        n_rots, n_views = 1, n_views // 2
    render_poses = render_path_spiral(c2w, up, rads, focal, zdelta,
                                      zrate=0.5, rots=n_rots, N=n_views)
    render_poses = np.array(render_poses).astype(np.float32)

    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    return images, poses, bds, render_poses, i_test


def load_llff_data_nex(basedir, factor=8, recenter=True, bd_factor=0.75,
                       spherify=False):
    """The NeX-style LLFF loader: intrinsics come from ``hwf_cxcy.npy``
    ([h, w, f, cx, cy]) when present, and are returned separately instead
    of being baked into the pose array.

    Returns (images, poses, bds, render_poses, i_test, intrinsic) where
    intrinsic = [h, w, f] (+ [cx, cy] when hwf_cxcy.npy exists)."""
    hwf_path = os.path.join(basedir, "hwf_cxcy.npy")
    images, poses, bds, render_poses, i_test = load_llff_data(
        basedir, factor, recenter, bd_factor, spherify)
    if os.path.exists(hwf_path):
        intrinsic = np.load(hwf_path).astype(np.float64)
        f = factor if factor else 1
        intrinsic = np.concatenate([intrinsic[:2] / f, intrinsic[2:] / f])
        intrinsic[:2] = np.round(intrinsic[:2])
    else:
        intrinsic = poses[0, :3, 4].copy()
    return images, poses, bds, render_poses, i_test, intrinsic
