"""The data-layer functions that no entry point of the JAX package reaches,
in the port, against the JAX package on the CPU: the video-path datasets
(``CameraViewCellDataset``, ``MultipleViewCellCameraDataset``),
``ViewCellDataset.load_nogt_weights`` and
``SpherePosDir.warp_depth_images``, on a ``make_scene`` scene."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adanerf_tpu.config import Config as JConfig
from adanerf_tpu.data import dataset as jdataset
from adanerf_tpu.pipeline import features as jfeatures
from adanerf_tpu_torch.config import Config as TConfig
from adanerf_tpu_torch.data import dataset as tdataset
from adanerf_tpu_torch.pipeline import features as tfeatures

from scene_utils import dense_config_args, make_scene

CAMERAS = ["CenteredCamera", "RotatingCamera", "TranslatingCamera", "ViewCellForwardCamera",
           "PredefinedCamera"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 24x20 sphere scene with depth maps and a 4-pose camera path
    (``cam_path_pan.json``, the train poses)."""
    d = make_scene(str(tmp_path_factory.mktemp("scene_data") / "scene"), w=24, h=20,
                   n_train=4, with_depth=True)
    with open(os.path.join(d, "transforms_train.json")) as f:
        frames = json.load(f)["frames"]
    with open(os.path.join(d, "cam_path_pan.json"), "w") as f:
        json.dump({"frames": [{"transform_matrix": fr["transform_matrix"]} for fr in frames]}, f)
    return d


def _configs(scene, tmp_path, extra=()):
    argv = dense_config_args(scene, str(tmp_path)) + list(extra)
    return JConfig.init(argv=argv), TConfig.init(argv=argv)


def _video_set(pkg, scene, tmp_path, cam, cls="CameraViewCellDataset", *args):
    """The JAX package's (pkg "jax") or the port's ("port") video dataset."""
    conf, mod = (JConfig, jdataset) if pkg == "jax" else (TConfig, tdataset)
    c = conf.init(argv=dense_config_args(scene, str(tmp_path)) + [
        "--camType", cam, "--videoFrames", "6", "--camCenter", "0.1", "--camCenter", "0",
        "--camCenter", "2.9", "--camRadius", "0.2", "--camRightAngle", "12", "--camUpAngle",
        "7", "--movementVector", "0.4", "--movementVector", "0.1", "--movementVector", "0"])
    return getattr(mod, cls)(c, mod.DatasetInfo(c), *args)


def _video_sets(scene, tmp_path, cam, cls="CameraViewCellDataset", *args):
    return tuple(_video_set(pkg, scene, tmp_path, cam, cls, *args) for pkg in ("jax", "port"))


@pytest.mark.parametrize("cam", CAMERAS)
def test_camera_view_cell_dataset_matches_jax(scene, tmp_path, cam):
    j, t = _video_sets(scene, tmp_path, cam)
    assert len(t) == len(j) > 0 and t.image_filenames == j.image_filenames
    for k in ("poses", "rotations", "directions"):
        got, want = getattr(t, k), np.asarray(getattr(j, k))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert t.color_images is None and t.depth_images is None and (t.w, t.h) == (24, 20)


def _view_cell(name, center, half):
    """A view cell around ``center`` (3,) of half-size ``half`` (3,)."""
    m = np.eye(4)
    m[:3, 3] = center
    world = np.diag(list(half) + [1.0])
    world[:3, 3] = center
    return {"view_cell_name": name, "view_cell_orientation": m.tolist(),
            "view_cell_size": [2 * h for h in half], "view_cell_matrix_world": world.tolist()}


def test_multiple_view_cells_match_jax(scene, tmp_path):
    """Two overlapping cells (each pose of the path in one or both): the
    same cell names, radii and distances per pose; a pose outside every
    cell raises ValueError in both packages."""
    cells = [_view_cell("a", (0.0, 0.0, 3.0), (0.3, 0.3, 0.3)),
             _view_cell("b", (0.05, 0.0, 3.0), (0.25, 0.3, 0.4))]
    j, t = _video_sets(scene, tmp_path, "PredefinedCamera", "MultipleViewCellCameraDataset",
                       cells)
    assert t.pose_to_view_cells == j.pose_to_view_cells
    assert len(t.pose_to_view_cells) == 4
    assert {len(c["indices"]) for c in t.pose_to_view_cells} >= {2}
    far = [_view_cell("far", (5.0, 0.0, 3.0), (0.1, 0.1, 0.1))]
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError, match="could not find view cell"):
            _video_set(pkg, scene, tmp_path, "PredefinedCamera",
                       "MultipleViewCellCameraDataset", far)


@pytest.mark.parametrize("suffix", [".trch.npy", ".trch"])
def test_load_nogt_weights_matches_jax(scene, tmp_path, suffix):
    w = np.random.RandomState(0).rand(20, 24, 16).astype(np.float32)
    path = str(tmp_path / ("weights" + suffix))
    if suffix.endswith(".npy"):
        np.save(path, w)
    else:
        torch.save(torch.from_numpy(w), path)
    jc, tc = _configs(scene, tmp_path)
    j = jdataset.ViewCellDataset(jc, jdataset.DatasetInfo(jc), "val", load_images=False)
    t = tdataset.ViewCellDataset(tc, tdataset.DatasetInfo(tc), "val", load_images=False)
    got, want = t.load_nogt_weights(path), j.load_nogt_weights(path)
    assert got.dtype == want.dtype and got.shape == (20, 24, 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("transform", ["log", "linear"])
def test_warp_depth_images_matches_jax(scene, tmp_path, transform):
    """The GT depth maps of the train split warped to the view-cell sphere:
    within 1e-6."""
    jc, tc = _configs(scene, tmp_path, ["--depthTransform", transform])
    jc.trainWithGTDepth = tc.trainWithGTDepth = True
    jinfo, tinfo = jdataset.DatasetInfo(jc), tdataset.DatasetInfo(tc)
    ds = tdataset.ViewCellDataset(tc, tinfo, "train")
    assert ds.depth_images is not None and (ds.depth_images == 1.0).any()
    jf = jfeatures.SpherePosDir(jc, 0, jinfo.scene_static())
    tf = tfeatures.SpherePosDir(tc, 0, tinfo.scene_static())
    want = np.asarray(jf.warp_depth_images(jnp.asarray(ds.depth_images),
                                           jnp.asarray(ds.rotations), jnp.asarray(ds.poses),
                                           jnp.asarray(ds.directions)))
    got = tf.warp_depth_images(ds.depth_images, ds.rotations, ds.poses, ds.directions)
    assert tuple(got.shape) == want.shape == ds.depth_images.shape
    err = float(np.abs(got.numpy() - want).max())
    print(f"{transform}: max abs err {err:.3e}")
    assert err <= 1e-6
    assert ((got == 1.0).numpy() == (want == 1.0)).all()
