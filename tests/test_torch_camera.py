"""The port's copy of the camera paths (adanerf_tpu_torch/data/camera.py)
against the JAX package's adanerf_tpu/data/camera.py: the camera path file
of demo/llff_scene and every camera class, bit for bit."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from adanerf_tpu.data import camera as jcamera
from adanerf_tpu_torch.data import camera as tcamera

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLFF = os.path.join(ROOT, "demo", "llff_scene")

CONFIG = SimpleNamespace(videoFrames=12, camCenter=[0.1, -0.2, 0.3], camRadius=1.5,
                         camRightAngle=20.0, camUpAngle=10.0, movementVector=[1.0, 0.5, -0.25],
                         data=LLFF, camPath="cam_path_spiral")
INFO = SimpleNamespace(view=SimpleNamespace(view_cell_center=[0.0, 1.0, 2.0],
                                            view_cell_size=[0.5, 0.4, 0.3],
                                            base_rotation=np.eye(3)))


@pytest.mark.parametrize("frames", [-1, 0, 7, 500])
def test_camera_path_file_matches_jax(frames):
    got = tcamera.PredefinedCamera.import_camera_path(LLFF, "cam_path_spiral", frames)
    want = jcamera.PredefinedCamera.import_camera_path(LLFF, "cam_path_spiral", frames)
    assert got.dtype == want.dtype == np.float32 and got.shape[1:] == (4, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["CenteredCamera", "RotatingCamera", "TranslatingCamera",
                                  "ViewCellForwardCamera", "PredefinedCamera"])
def test_camera_class_matches_jax(name):
    got = tcamera.get_camera(name).calc_positions(CONFIG, data=INFO)
    want = jcamera.get_camera(name).calc_positions(CONFIG, data=INFO)
    assert got.shape == want.shape and got.shape[1:] == (4, 4)
    np.testing.assert_array_equal(got, want)
    config = SimpleNamespace(**vars(CONFIG), camType=name)
    np.testing.assert_array_equal(tcamera.camera_path_transforms(config, INFO), want)


def test_euler2mat_is_a_rotation_and_matches_jax():
    for angles in [(0.0, 0.0, 0.0), (0.3, -1.2, 2.0), (np.pi, 0.5, -0.7)]:
        m = tcamera.euler2mat(*angles)
        np.testing.assert_array_equal(m, jcamera.euler2mat(*angles))
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-12)
