"""Parametric and file-based camera paths for video rendering and the
viewer's ``--camPath``.

A copy of ``adanerf_tpu/data/camera.py`` (numpy only; the port imports
nothing of the JAX package). Each class's ``calc_positions`` returns
(N, 4, 4) camera-to-world transforms: ``[:3, 3]`` is the position and
``[:3, :3]`` the rotation."""

from __future__ import annotations

import json
import os

import numpy as np


def euler2mat(ai, aj, ak):
    """Static-frame xyz euler angles -> rotation matrix (the transforms3d
    'sxyz' convention the reference relies on)."""
    si, sj, sk = np.sin(ai), np.sin(aj), np.sin(ak)
    ci, cj, ck = np.cos(ai), np.cos(aj), np.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    m = np.eye(3)
    m[0, 0] = cj * ck
    m[0, 1] = sj * sc - cs
    m[0, 2] = sj * cc + ss
    m[1, 0] = cj * sk
    m[1, 1] = sj * ss + cc
    m[1, 2] = sj * cs - sc
    m[2, 0] = -sj
    m[2, 1] = cj * si
    m[2, 2] = cj * ci
    return m


class CenteredCamera:
    @classmethod
    def calc_positions(cls, config, **kwargs):
        matrices = []
        for angle in np.arange(0, 2 * np.pi, 2 * np.pi / config.videoFrames):
            T = np.eye(4)
            T[:3, 3] = np.array(config.camCenter)
            T[2, 3] += config.camRadius
            R = np.eye(4)
            R[:3, :3] = euler2mat(np.sin(angle) * np.deg2rad(config.camRightAngle),
                                  np.cos(angle) * np.deg2rad(config.camUpAngle), 0)
            matrices.append((R @ T)[None])
        return np.concatenate(matrices, axis=0)


class RotatingCamera:
    @classmethod
    def calc_positions(cls, config, **kwargs):
        matrices = []
        for angle in np.arange(0, 2 * np.pi, 2 * np.pi / config.videoFrames):
            T = np.eye(4)
            T[:3, 3] = np.array(config.camCenter)
            T[2, 3] += config.camRadius
            T[:3, :3] = euler2mat(np.sin(angle) * np.deg2rad(config.camRightAngle),
                                  np.cos(angle) * np.deg2rad(config.camUpAngle), 0)
            matrices.append(T[None])
        return np.concatenate(matrices, axis=0)


class TranslatingCamera:
    @classmethod
    def calc_positions(cls, config, **kwargs):
        matrices = []
        for step in np.arange(-1.0, 1.0, 2.0 / config.videoFrames):
            T = np.eye(4)
            T[:3, 3] = np.array(config.camCenter)
            T[2, 3] += config.camRadius
            T[0:3, 3] += np.array(config.movementVector) * step
            matrices.append(T[None])
        return np.concatenate(matrices, axis=0)


class ViewCellForwardCamera:
    @classmethod
    def calc_positions(cls, config, **kwargs):
        matrices = []
        data = kwargs.get('data', None)
        view_cell_center = np.array(data.view.view_cell_center)
        view_cell_size = np.array(data.view.view_cell_size)
        for step in np.arange(0, 1.0, 1.0 / config.videoFrames):
            T = np.eye(4)
            T[1, 0:3] = np.array([0, 0, -1])
            T[2, 0:3] = np.array([0, 1, 0])
            T[:3, 3] = view_cell_center - (view_cell_size / 2) * np.array(config.movementVector)
            T[0:3, 3] += np.array(config.movementVector) * step * view_cell_size
            matrices.append(T[None])
        return np.concatenate(matrices, axis=0)


class PredefinedCamera:
    @classmethod
    def calc_positions(cls, config, **kwargs):
        frames = 0 if not config.videoFrames else config.videoFrames
        return cls.import_camera_path(config.data, config.camPath, frames)

    @classmethod
    def import_camera_path(cls, path, file_name, num_frames=-1):
        with open(os.path.join(path, f"{file_name}.json")) as f:
            file = json.load(f)
        transforms = np.array([np.array(fr["transform_matrix"], np.float32)
                               for fr in file["frames"]])
        if 0 < num_frames < len(transforms):
            transforms = transforms[:num_frames]
        return transforms


_CAMERAS = {"CenteredCamera": CenteredCamera, "RotatingCamera": RotatingCamera,
            "TranslatingCamera": TranslatingCamera,
            "ViewCellForwardCamera": ViewCellForwardCamera,
            "PredefinedCamera": PredefinedCamera}


def get_camera(name: str):
    return _CAMERAS[name]


def camera_path_transforms(config, dataset_info):
    """(N, 4, 4) camera transforms for the configured video path."""
    cam = get_camera(config.camType)
    return cam.calc_positions(config, data=dataset_info,
                              base_rotation=dataset_info.view.base_rotation)
