"""Dataset preparation: the depth ranges of a view-cell scene.

  python -m adanerf_tpu_torch.prepare_dataset -data <scene>

Counterpart of the JAX package's root ``prepare_dataset.py``. From the
per-frame depth maps (``<frame>_depth.npz``) of all three splits it
computes ``depth_ignore``, ``depth_range`` and the sphere-warped log and
linear depth ranges, then rewrites ``dataset_info.json``. Three passes:

  1. the global max depth (the 'ignore' / background value),
  2. depth range = [0.95 min, 1.05 max] of foreground depth / camera_scale,
  3. warped ranges: per frame, subtract the distance at which each ray
     leaves the view-cell sphere from its world depth and track min and max
     under the log and linear transforms.

All on the host in numpy, through the port's ``ops/depth_transforms.py``
and ``ops/raygen.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .ops import depth_transforms as dt
from .ops.raygen import generate_ray_directions


def load_depth_image(filename, h, w, flip_depth):
    np_file = np.load(filename)
    depth = np_file["depth"] if "depth" in np_file.files else np_file[np_file.files[0]]
    depth = depth.astype(np.float32).reshape(h, w)
    if flip_depth:
        depth = np.flip(depth, 0)
    return depth


def ray_sphere_offsets(directions, transform, center, radius):
    """Per-pixel distance to the view-cell-sphere exit (numpy)."""
    pose = transform[:3, 3]
    rotation = transform[:3, :3]
    nds = directions @ rotation.T
    omc = pose - center
    u_dot = nds @ omc
    delta = u_dot ** 2 - (np.dot(omc, omc) - radius ** 2)
    return -u_dot + np.sqrt(np.clip(delta, 0, None))


def warped_min_max(depth_unit, max_depth_locations, depth_range, transform,
                   directions, center, radius, depth_transform):
    """Min/max of (world depth - sphere offset) under a depth transform."""
    d = depth_transform.from_world(
        dt.LinearTransform.to_world(depth_unit.copy(), depth_range), depth_range)
    d = np.asarray(d)
    d[max_depth_locations] = 1.0

    offsets = ray_sphere_offsets(directions, transform, center, radius)
    mask = d == 1.0
    dw = np.asarray(depth_transform.to_world(d, depth_range))
    dw = dw - offsets.reshape(dw.shape)
    min_v = dw.min()
    dw[mask] = 0
    return min_v, dw.max()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-data", "--dataset", required=True, type=str)
    args = p.parse_args(argv)
    path = args.dataset
    splits = ["train", "val", "test"]

    info_path = os.path.join(path, "dataset_info.json")
    with open(info_path) as f:
        info = json.load(f)

    w, h = info["resolution"][0], info["resolution"][1]
    flip_depth = info.get("flip_depth", False)
    depth_distance_adjustment = info.get("depth_distance_adjustment", False)
    camera_scale = float(info.get("camera_scale", 1.0))
    fov = float(info["camera_angle_x"])
    focal = float(0.5 * w / np.tan(0.5 * fov))

    ray_dirs = generate_ray_directions(w, h, fov, focal)
    base_ray_z = np.abs(ray_dirs[:, :, 2]).astype(np.float32)
    directions = ray_dirs.reshape(-1, 3).astype(np.float32)

    frames_by_split = {}
    for s in splits:
        with open(os.path.join(path, f"transforms_{s}.json")) as f:
            frames_by_split[s] = json.load(f)["frames"]

    # pass 1: global max depth
    max_depth = float("-inf")
    for s in splits:
        for frame in frames_by_split[s]:
            dfile = os.path.join(path, frame["file_path"] + "_depth.npz")
            if not os.path.exists(dfile):
                print(f"Error: no depth data for {frame['file_path']}")
                sys.exit(-1)
            max_depth = max(float(load_depth_image(dfile, h, w, flip_depth).max()),
                            max_depth)

    # pass 2: scaled foreground depth range
    min_z, max_z = float("inf"), float("-inf")
    for s in splits:
        for frame in frames_by_split[s]:
            dfile = os.path.join(path, frame["file_path"] + "_depth.npz")
            depth = load_depth_image(dfile, h, w, flip_depth)
            bg = depth == max_depth
            if depth_distance_adjustment:
                depth = depth / base_ray_z
            depth[bg] = -10 * max_depth
            max_z = max(1.05 * float(depth.max()), max_z)
            depth[bg] = 10 * max_depth
            min_z = min(0.95 * float(depth.min()), min_z)

    depth_range = [min_z / camera_scale, max_z / camera_scale]
    info["depth_ignore"] = float(max_depth)
    info["depth_range"] = depth_range

    center = np.array(info["view_cell_center"], np.float32)
    size = np.array(info["view_cell_size"], np.float32)
    radius = 0.5 * float(np.sqrt(np.sum(size ** 2)))

    # pass 3: warped ranges under both transforms
    min_log = max_lin = None
    min_v_log, max_v_log = depth_range[1], depth_range[0]
    min_v_lin, max_v_lin = depth_range[1], depth_range[0]
    for s in splits:
        for frame in frames_by_split[s]:
            dfile = os.path.join(path, frame["file_path"] + "_depth.npz")
            depth = load_depth_image(dfile, h, w, flip_depth)
            bg = depth == max_depth
            if depth_distance_adjustment:
                depth = depth / base_ray_z
            depth_unit = (depth - min_z) / (max_z - min_z)
            transform = np.array(frame["transform_matrix"], np.float32)

            lo, hi = warped_min_max(depth_unit, bg, depth_range, transform,
                                    directions, center, radius, dt.LogTransform)
            min_v_log, max_v_log = min(min_v_log, lo), max(max_v_log, hi)
            lo, hi = warped_min_max(depth_unit, bg, depth_range, transform,
                                    directions, center, radius, dt.LinearTransform)
            min_v_lin, max_v_lin = min(min_v_lin, lo), max(max_v_lin, hi)

    warped_log = [depth_range[0], depth_range[1]]
    if min_v_log < depth_range[0]:
        warped_log[0] = 0.95 * float(min_v_log)
    if max_v_log < depth_range[1]:
        warped_log[1] = 1.05 * float(max_v_log)
    warped_lin = [depth_range[0], depth_range[1]]
    if min_v_lin < depth_range[0]:
        warped_lin[0] = 0.95 * float(min_v_lin)
    if max_v_lin < depth_range[1]:
        warped_lin[1] = 1.05 * float(max_v_lin)

    info["depth_range_warped_log"] = warped_log
    info["depth_range_warped_lin"] = warped_lin

    print(f"depth ignore value: {max_depth}")
    print(f"depth range: {depth_range}")
    print(f"depth range warped (log): {warped_log}")
    print(f"depth range warped (lin): {warped_lin}")

    with open(info_path, "w") as f:
        json.dump(info, f, indent=4)
    return info


if __name__ == "__main__":
    main(sys.argv[1:])
