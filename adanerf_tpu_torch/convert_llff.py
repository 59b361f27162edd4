"""Convert an LLFF scene into the view-cell format:

  python -m adanerf_tpu_torch.convert_llff -dir <scene> [-factor N] [-nex 1]

Counterpart of the JAX package's root ``convert_llff.py``. From the scene's
``poses_bounds.npy`` and ``images/`` (or ``images_N/``) it writes
``dataset_info.json``, the spiral camera path ``cam_path_spiral.json``,
``transforms_{train,val,test}.json`` (every 8th image is a test and val
image) and the split folders' PNGs (through ``data/png.py::write_png``,
where the JAX package uses PIL). ``-nex 1`` takes the intrinsics from
``hwf_cxcy.npy``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .data.llff import load_llff_data, load_llff_data_nex
from .data.png import write_png


def listify_matrix(matrix):
    return [[float(v) for v in row] for row in matrix]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument('-dir', '--dir', default="", type=str)
    p.add_argument('-factor', '--factor', default=None, type=int)
    p.add_argument('-nex', '--nex', default=0, type=int,
                   help="use the NeX-style loader (hwf_cxcy.npy intrinsics)")
    cl = p.parse_args(argv)

    if cl.nex == 0:
        images, poses, bds, render_poses, i_test = load_llff_data(
            cl.dir, cl.factor, recenter=True, bd_factor=0.75, spherify=False)
        hwf = poses[0, :3, -1]
    else:
        images, poses, bds, render_poses, i_test, intrinsic = \
            load_llff_data_nex(cl.dir, cl.factor, recenter=True, bd_factor=0.75, spherify=False)
        hwf = np.asarray(intrinsic[:3]).flatten()
    poses = poses[:, :3, :4]

    llff_hold = 8
    print('Loaded llff', images.shape, hwf, cl.dir)

    near = float(np.min(bds) * 0.9)
    far = float(np.max(bds) * 1.0)
    print('NEAR FAR', near, far)

    view_cell_center = poses[:, :, 3:].mean(axis=0)
    view_cell_size = 2 * np.abs(poses[:, :, 3:] - view_cell_center).max(axis=0)

    i_test = np.arange(images.shape[0])[::llff_hold]
    i_val = i_test
    i_train = np.array([i for i in range(images.shape[0])
                        if i not in i_test and i not in i_val])
    dataset_indices = {'train': i_train, 'val': i_val, 'test': i_test}

    with open(os.path.join(cl.dir, "dataset_info.json"), "w") as f:
        json.dump({
            'camera_angle_x': float(2 * np.arctan((hwf[1] * 0.5) / hwf[2])),
            'view_cell_center': np.squeeze(view_cell_center).tolist(),
            'view_cell_size': np.squeeze(view_cell_size).tolist(),
            'resolution': [int(images.shape[2]), int(images.shape[1])],
            'flip_depth': False,
            'depth_distance_adjustment': False,
            'depth_ignore': 1.01 * far,
            'depth_range': [near, far],
            'depth_range_warped_log': [near, far],
            'depth_range_warped_lin': [near, far],
        }, f, indent=4)

    out_data = {"frames": []}
    for frame_idx, pose_frame in enumerate(render_poses[:, :3, :4]):
        m = listify_matrix(pose_frame)
        m.append([0.0, 0.0, 0.0, 1.0])
        out_data["frames"].append({"p": frame_idx, "transform_matrix": m})
    with open(os.path.join(cl.dir, "cam_path_spiral.json"), "w") as f:
        json.dump(out_data, f, indent=4)

    for s, split_indices in dataset_indices.items():
        out_data = {'frames': []}
        sub = os.path.join(cl.dir, s)
        os.makedirs(sub, exist_ok=True)
        for frame_idx in split_indices:
            m = listify_matrix(poses[frame_idx])
            m.append([0.0, 0.0, 0.0, 1.0])
            out_data['frames'].append({
                'file_path': f"./{s}/{frame_idx:05d}",
                'rotation': 0,
                'transform_matrix': m,
            })
            write_png(os.path.join(sub, f"{frame_idx:05d}.png"),
                      (images[frame_idx] * 255).astype(np.uint8))
        with open(os.path.join(cl.dir, f'transforms_{s}.json'), 'w') as fp:
            json.dump(out_data, fp, indent=4)
    return cl.dir


if __name__ == "__main__":
    main(sys.argv[1:])
