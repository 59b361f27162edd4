"""Synthetic DONeRF-format and LLFF-format scenes, made without a download.

The port's copy of the scene code of ``tests/scene_utils.py`` (which the
JAX package's tools use): analytic renders of coloured spheres (one, a
layered arrangement with strong view-cell parallax, or translucent shells
in an enclosing room) from seeded poses, written with the port's own PNG
writer (``data/png.py``) so that it runs where there is no imageio.
``make_synthetic_scene.py`` and ``make_llff_scene.py`` are its CLIs.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..data.png import write_png
from ..ops.raygen import generate_ray_directions


def look_at_matrix(eye):
    """Camera at `eye` looking at the origin, y-up-ish."""
    eye = np.asarray(eye, np.float64)
    forward = -eye / np.linalg.norm(eye)          # towards origin
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    m = np.eye(4)
    # camera convention: dirs have -z forward (raygen flips z)
    m[:3, 0] = right
    m[:3, 1] = up
    m[:3, 2] = -forward
    m[:3, 3] = eye
    return m


def render_sphere_image(pose, rotation, w, h, fov, focal,
                        sphere_r=1.0, far=10.0):
    """Analytic render of a colored lambertian-ish sphere + depth map."""
    dirs = generate_ray_directions(w, h, fov, focal).reshape(-1, 3)
    world_dirs = dirs @ rotation.T
    o = np.broadcast_to(pose, world_dirs.shape)

    b = np.sum(o * world_dirs, axis=-1)
    c = np.sum(o * o, axis=-1) - sphere_r ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit &= t > 0

    img = np.zeros((w * h, 3), np.float32)
    depth = np.full((w * h,), far, np.float32)
    p = o + world_dirs * t[:, None]
    normal = p / sphere_r
    img[hit] = np.abs(normal[hit]) * 0.8 + 0.2
    depth[hit] = t[hit]
    return img.reshape(h, w, 3), depth.reshape(h, w)


def render_spheres_image(pose, rotation, w, h, fov, focal, spheres,
                         far=10.0):
    """Nearest-hit raytrace of several colored spheres.

    spheres: list of (center(3,), radius, base_color(3,)). Returns
    ((h, w, 3) rgb, (h, w) depth) like render_sphere_image."""
    dirs = generate_ray_directions(w, h, fov, focal).reshape(-1, 3)
    world_dirs = dirs @ rotation.T
    o = np.broadcast_to(pose, world_dirs.shape)

    img = np.zeros((w * h, 3), np.float32)
    depth = np.full((w * h,), far, np.float32)
    for sc, sr, scol in spheres:
        oc = o - np.asarray(sc, np.float64)
        b = np.sum(oc * world_dirs, axis=-1)
        cq = np.sum(oc * oc, axis=-1) - sr ** 2
        disc = b * b - cq
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit = (disc > 0) & (t > 0) & (t < depth)
        p = oc + world_dirs * t[:, None]
        normal = p / sr
        shade = np.abs(normal) * 0.5 + 0.5
        img[hit] = (shade[hit] * np.asarray(scol, np.float32)).clip(0, 1)
        depth[hit] = t[hit]
    return img.reshape(h, w, 3), depth.reshape(h, w)


def multi_object_spheres():
    """A layered arrangement with strong view-cell parallax: objects at
    depths ~2-6.5 with occlusion edges everywhere, so the trained oracle
    must hedge across depth bins (2-3 samples a ray)."""
    return [
        ((-0.9, 0.6, 1.2), 0.55, (1.0, 0.45, 0.35)),
        ((0.8, -0.5, 0.9), 0.6, (0.4, 0.8, 1.0)),
        ((0.1, 0.8, 0.0), 0.5, (0.6, 1.0, 0.5)),
        ((-0.6, -0.8, -0.3), 0.65, (1.0, 0.9, 0.4)),
        ((0.9, 0.7, -1.1), 0.7, (0.9, 0.5, 1.0)),
        ((0.0, -0.1, -1.6), 0.8, (0.5, 0.6, 0.9)),
        ((-1.2, 0.1, -2.4), 0.9, (1.0, 0.7, 0.6)),
        ((1.1, -0.9, -2.8), 0.95, (0.55, 0.95, 0.8)),
    ]


def translucent_spheres():
    """Glass-like shells: rays cross several semi-transparent surfaces at
    distinct depths before terminating on an opaque interior object or the
    enclosing room sphere, so the trained oracle must keep 2-4 depth bins
    above threshold (the paper's multi-surface regime).

    Entries are (center, radius, base_color, alpha)."""
    return [
        # overlapping translucent shells (both entry+exit surfaces count)
        ((0.0, 0.0, 0.4), 1.25, (0.55, 0.8, 1.0), 0.45),
        ((-0.5, 0.3, -0.4), 0.9, (1.0, 0.6, 0.45), 0.5),
        ((0.6, -0.35, -0.2), 0.8, (0.6, 1.0, 0.55), 0.5),
        ((0.15, 0.55, -1.2), 0.7, (1.0, 0.85, 0.4), 0.55),
        # opaque interior objects (hard depth edges inside the glass)
        ((0.05, -0.05, -0.1), 0.32, (0.95, 0.4, 0.75), 1.0),
        ((-0.45, -0.5, -0.9), 0.3, (0.4, 0.55, 1.0), 1.0),
        ((0.7, 0.55, -1.0), 0.28, (0.45, 0.9, 0.9), 1.0),
        # enclosing room: every ray terminates on its interior wall, so
        # there is no unbounded background (cameras sit inside, see the
        # exit intersection)
        ((0.0, 0.0, 0.0), 9.0, (0.72, 0.74, 0.8), 1.0),
    ]


def render_translucent_image(pose, rotation, w, h, fov, focal, spheres,
                             far=16.0):
    """Front-to-back alpha composite over every sphere surface along each
    ray. Each sphere contributes its entry AND exit intersection as a
    shaded 'shell' surface (for the enclosing room only the exit is in
    front of the camera). Depth map records the first surface with alpha
    >= 0.5 (the sharp structure dataset prep should range over).

    spheres: list of (center(3,), radius, color(3,), alpha)."""
    dirs = generate_ray_directions(w, h, fov, focal).reshape(-1, 3)
    world_dirs = dirs @ rotation.T
    o = np.broadcast_to(pose, world_dirs.shape)
    n_rays = o.shape[0]

    ts, cols, alps = [], [], []
    for sc, sr, scol, sa in spheres:
        oc = o - np.asarray(sc, np.float64)
        b = np.sum(oc * world_dirs, axis=-1)
        cq = np.sum(oc * oc, axis=-1) - sr ** 2
        disc = b * b - cq
        root = np.sqrt(np.maximum(disc, 0))
        for sgn in (-1.0, 1.0):                  # entry, exit shells
            t = -b + sgn * root
            ok = (disc > 0) & (t > 1e-3)
            p = oc + world_dirs * t[:, None]
            normal = p / sr
            shade = np.abs(normal) * 0.5 + 0.5
            ts.append(np.where(ok, t, np.inf))
            cols.append((shade * np.asarray(scol, np.float32)).clip(0, 1)
                        .astype(np.float32))
            alps.append(np.where(ok, np.float32(sa), np.float32(0.0)))

    t_all = np.stack(ts, axis=1)                 # (rays, 2*n_spheres)
    c_all = np.stack(cols, axis=1)
    a_all = np.stack(alps, axis=1)
    order = np.argsort(t_all, axis=1)
    t_all = np.take_along_axis(t_all, order, axis=1)
    a_all = np.take_along_axis(a_all, order, axis=1)
    c_all = np.take_along_axis(c_all, order[..., None], axis=1)

    img = np.zeros((n_rays, 3), np.float32)
    trans = np.ones((n_rays,), np.float32)
    depth = np.full((n_rays,), far, np.float32)
    has_depth = np.zeros((n_rays,), bool)
    for k in range(t_all.shape[1]):
        a = np.where(np.isfinite(t_all[:, k]), a_all[:, k], 0.0)
        img += (trans * a)[:, None] * c_all[:, k]
        solid = (~has_depth) & (a >= 0.5)
        depth[solid] = t_all[solid, k].astype(np.float32)
        has_depth |= solid
        trans *= 1.0 - a
    return (img.clip(0, 1).reshape(h, w, 3),
            np.minimum(depth, far).reshape(h, w))


def make_scene(tmpdir, w=24, h=24, n_train=4, n_val=1, n_test=1,
               with_depth=False, objects="sphere", cell_frac=0.2):
    """A DONeRF-format scene in ``tmpdir``: ``dataset_info.json``,
    ``transforms_{train,val,test}.json`` and each split's PNG images (and,
    ``with_depth``, ``*_depth.npz`` depth maps), of ``objects`` ("sphere":
    one coloured sphere; "multi": layered spheres in a wide view cell;
    "translucent": glass shells in an enclosing room) seen from seeded
    poses in the view cell."""
    os.makedirs(tmpdir, exist_ok=True)
    fov = 0.8
    focal = 0.5 * w / np.tan(0.5 * fov)
    center = [0.0, 0.0, 3.0]
    far = 8.0
    translucent = None
    if objects == "multi":
        # wider view cell -> real parallax -> multi-sample oracles
        cell_size = [1.2, 1.2, 1.2]
        spheres = multi_object_spheres()
    elif objects == "translucent":
        # glass shells + enclosing room: multi-surface rays everywhere
        cell_size = [1.2, 1.2, 1.2]
        far = 16.0
        translucent = translucent_spheres()
        spheres = None
    else:
        cell_size = [0.5, 0.5, 0.5]
        spheres = None

    info = {
        "view_cell_center": center,
        "view_cell_size": cell_size,
        "resolution": [w, h],
        "camera_angle_x": fov,
        "flip_depth": False,
        "depth_distance_adjustment": False,
        "depth_ignore": far,
        "depth_range": [1.0, far],
        "depth_range_warped_log": [0.1, far],
        "depth_range_warped_lin": [0.1, far],
    }
    with open(os.path.join(tmpdir, "dataset_info.json"), "w") as f:
        json.dump(info, f)

    rng = np.random.RandomState(0)
    counts = {"train": n_train, "val": n_val, "test": n_test}
    for split, n in counts.items():
        os.makedirs(os.path.join(tmpdir, split), exist_ok=True)
        frames = []
        for i in range(n):
            offset = rng.uniform(-cell_frac, cell_frac, 3) * np.array(cell_size)
            eye = np.array(center) + offset
            m = look_at_matrix(eye)
            pose = m[:3, 3]
            rot = m[:3, :3]
            if translucent is not None:
                img, depth = render_translucent_image(pose, rot, w, h, fov,
                                                      focal, translucent,
                                                      far=far)
            elif spheres is not None:
                img, depth = render_spheres_image(pose, rot, w, h, fov,
                                                  focal, spheres, far=far)
            else:
                img, depth = render_sphere_image(pose, rot, w, h, fov, focal,
                                                 far=far)
            name = f"{split}/{i:04d}"
            write_png(os.path.join(tmpdir, name + ".png"), (img * 255).astype(np.uint8))
            if with_depth:
                np.savez(os.path.join(tmpdir, name + "_depth.npz"), depth=depth)
            frames.append({"file_path": "./" + name,
                           "transform_matrix": m.tolist()})
        with open(os.path.join(tmpdir, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": frames}, f)
    return tmpdir


def make_llff_scene(tmpdir, w=96, h=72, n_images=24, fov=0.8, seed=0):
    """Forward-facing synthetic scene in RAW LLFF layout (``images/*.png`` +
    ``poses_bounds.npy``), the input contract of convert_llff.py /
    data/llff.py (reference: src/util/load_llff.py:239-312). Cameras jitter
    in a plane facing the multi-sphere arrangement; rotation columns are
    stored LLFF-style as [down, right, back] (the loader reorders them).
    """
    os.makedirs(os.path.join(tmpdir, "images"), exist_ok=True)
    focal = 0.5 * w / np.tan(0.5 * fov)
    far_plane = 8.0
    spheres = multi_object_spheres()
    base = np.array([0.0, 0.0, 3.0])

    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n_images):
        eye = base + rng.uniform(-1, 1, 3) * np.array([0.45, 0.35, 0.12])
        m = look_at_matrix(eye)          # c2w columns [right, up, back]
        pose, rot = m[:3, 3], m[:3, :3]
        img, depth = render_spheres_image(pose, rot, w, h, fov, focal,
                                          spheres, far=far_plane)
        write_png(os.path.join(tmpdir, "images", f"{i:04d}.png"),
                  (img * 255).astype(np.uint8))
        llff_rot = np.stack([-rot[:, 1], rot[:, 0], rot[:, 2]], axis=1)
        hwf = np.array([h, w, focal], np.float64)
        mat35 = np.concatenate([llff_rot, pose[:, None], hwf[:, None]],
                               axis=1)
        # bounds: scene depth range seen by this camera (z-depths)
        near = max(float(depth.min()) * 0.9, 0.1)
        far = float(depth[depth < far_plane].max()
                    if (depth < far_plane).any() else far_plane) * 1.1
        rows.append(np.concatenate([mat35.ravel(), [near, far]]))
    np.save(os.path.join(tmpdir, "poses_bounds.npy"),
            np.stack(rows).astype(np.float64))
    return tmpdir
