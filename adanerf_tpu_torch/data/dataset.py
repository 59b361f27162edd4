"""DONeRF-format view-cell datasets.

Counterpart of ``adanerf_tpu/data/dataset.py``. A scene directory holds
``dataset_info.json`` (view cell, resolution, fov, depth ranges),
``transforms_{train,val,test}.json`` (poses) and per-frame ``*.png`` (+
optional ``*_depth.npz``, or with ``--useNerfDepthMap`` an exported NeRF's
``*_QuantizedWeights_lo_nSD.raw``). A split is loaded whole into host
memory as numpy arrays; the train step gathers its rays from them (pixel
index convention ``y + h * x``). PNGs are decoded by ``data/png.py``. With
``--samplePlacementDir`` a split carries a ``SamplePlacementTracker`` (the
iterative sample placement's per-pixel active cells), read from
``<dir>/<split>/<samples>.ckpt.npy`` where that file exists.

Not ported yet: the streaming (bounded-memory) split (ROADMAP Queue 1,
item 6).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ..ops import depth_transforms as depth_transforms_mod
from ..ops.raygen import generate_ray_directions
from ..pipeline.features import SceneStatic
from .png import read_pngs


class View:
    def __init__(self):
        self.fov = 0.0
        self.focal = 0.0
        self.camera_scale = 1.0
        self.view_cell_center = [0, 0, 0]
        self.view_cell_size = [0, 0, 0]
        self.base_rotation = None


class DatasetInfo:
    """Scene metadata from dataset_info.json."""

    def __init__(self, config, in_feature_names: Optional[List[str]] = None):
        self.config = config
        self.dataset_path = config.data
        self.view = View()
        self.scale = config.scale

        in_feature_names = in_feature_names or list(config.inFeatures)
        self.use_warped_depth_range = []
        warped = False
        for name in in_feature_names:
            warped = warped or name == "SpherePosDir"
            self.use_warped_depth_range.append(warped)

        with open(os.path.join(self.dataset_path, "dataset_info.json")) as f:
            info = json.load(f)
        self.view.view_cell_center = info["view_cell_center"]
        self.view.view_cell_size = info["view_cell_size"]
        self.view.camera_scale = float(info.get("camera_scale", 1.0))
        if "camera_base_orientation" in info:
            self.view.base_rotation = np.array(info["camera_base_orientation"])

        self.w, self.h = info["resolution"][0], info["resolution"][1]
        if self.scale > 1:
            self.w //= self.scale
            self.h //= self.scale

        self.view.fov = float(info["camera_angle_x"])
        self.view.focal = float(0.5 * self.w / np.tan(0.5 * self.view.fov))
        self.flip_depth = info.get("flip_depth", False)
        self.depth_distance_adjustment = info.get("depth_distance_adjustment", False)

        required = ("depth_ignore", "depth_range", "depth_range_warped_log",
                    "depth_range_warped_lin")
        if any(k not in info for k in required):
            raise ValueError("necessary depth range information not found in "
                             "'dataset_info.json' — run prepare_dataset.py")

        self.depth_ignore = float(info["depth_ignore"])
        self.depth_range = [float(info["depth_range"][0]), float(info["depth_range"][1])]
        self.depth_max = self.depth_range[1]

        if config.depthTransform == "linear":
            self.depth_transform = depth_transforms_mod.LinearTransform
            self.depth_range_warped = [float(info["depth_range_warped_lin"][0]),
                                       float(info["depth_range_warped_lin"][1])]
        elif config.depthTransform == "log":
            self.depth_transform = depth_transforms_mod.LogTransform
            self.depth_range_warped = [float(info["depth_range_warped_log"][0]),
                                       float(info["depth_range_warped_log"][1])]
        else:
            self.depth_transform = depth_transforms_mod.NoneTransform
            self.depth_range_warped = [0, 1]
            self.depth_range = [0, 1]

    def scene_static(self) -> SceneStatic:
        return SceneStatic(
            w=self.w, h=self.h, fov=self.view.fov, focal=self.view.focal,
            view_cell_center=tuple(float(c) for c in self.view.view_cell_center),
            view_cell_radius=float(np.linalg.norm(
                np.array(self.view.view_cell_size) / 2.0)),
            depth_range=tuple(self.depth_range),
            depth_range_warped=tuple(self.depth_range_warped),
            depth_transform=self.depth_transform,
            depth_max=self.depth_max,
        )


def _scale_image(image: np.ndarray, scale: int) -> np.ndarray:
    """Area downscale by an integer factor (the mean of each scale x scale
    block)."""
    h, w = image.shape[0] // scale, image.shape[1] // scale
    blocks = image[:h * scale, :w * scale].reshape(h, scale, w, scale, *image.shape[2:])
    return blocks.mean(axis=(1, 3)).astype(image.dtype)


class ViewCellDataset:
    """One split of a view-cell scene fully loaded to host memory.

    Attributes:
      color_images: (N, h, w, 3) float32 in [0,1]
      depth_images: (N, h, w, 1) float32 normalized, or None
      poses: (N, 3); rotations: (N, 3, 3); directions: (h*w, 3)
    """

    def __init__(self, config, dataset_info: DatasetInfo, set_name="train",
                 num_samples=2048, load_images=True):
        self.config = config
        self.info = dataset_info
        self.set_name = set_name
        self.num_samples = num_samples
        self.dataset_path = config.data
        self.scale = dataset_info.scale
        self.w, self.h = dataset_info.w, dataset_info.h
        self.depth_ignore = dataset_info.depth_ignore
        self.depth_range = dataset_info.depth_range
        self.depth_transform = dataset_info.depth_transform
        self.flip_depth = dataset_info.flip_depth
        self.depth_distance_adjustment = dataset_info.depth_distance_adjustment
        self.load_depth = config.trainWithGTDepth or config.useNerfDepthMap
        self.image_filenames: List[str] = []

        self.base_ray_z = np.abs(generate_ray_directions(
            self.w, self.h, dataset_info.view.fov,
            dataset_info.view.focal)[:, :, 2]).astype(np.float32)

        with open(os.path.join(self.dataset_path, f"transforms_{set_name}.json")) as f:
            frames = json.load(f)["frames"]
        self.num_items = len(frames)
        transforms = np.zeros((self.num_items, 4, 4), np.float32)
        file_paths = []
        for i, frame in enumerate(frames):
            pose = np.array(frame["transform_matrix"], np.float32)
            transforms[i, :pose.shape[0], :pose.shape[1]] = pose
            file_paths.append(os.path.join(self.dataset_path, frame["file_path"][2:]))
            self.image_filenames.append(file_paths[-1] + ".png")

        color_images = depth_images = None
        if load_images and self.num_items > 0:
            color_images = np.zeros((self.num_items, self.h, self.w, 3), np.float32)
            for i, img in enumerate(read_pngs(self.image_filenames)):
                color_images[i] = self._color_image(img, self.image_filenames[i])
            if self.load_depth:
                for i, file_path in enumerate(file_paths):
                    d = None
                    if config.useNerfDepthMap and os.path.exists(
                            file_path + "_QuantizedWeights_lo_nSD.raw"):
                        d = self.load_exported_nerf_depth(
                            file_path + "_QuantizedWeights_lo_nSD.raw")
                    if d is None and os.path.exists(file_path + "_depth.npz"):
                        d = self.load_depth_image(file_path + "_depth.npz")
                    if d is not None:
                        if depth_images is None:
                            depth_images = np.zeros(
                                (self.num_items, d.shape[1], d.shape[2], 1), np.float32)
                        depth_images[i] = d[0]

        self.color_images = color_images
        self.depth_images = depth_images
        self.poses = transforms[:, :3, 3].copy()
        self.rotations = transforms[:, :3, :3].copy()
        self.directions = generate_ray_directions(
            self.w, self.h, dataset_info.view.fov,
            dataset_info.view.focal).reshape(-1, 3).astype(np.float32)

        self.sample_placement_tracker = None
        sp_dir = getattr(config, "samplePlacementDir", None)
        if sp_dir and set_name != "vid":
            if not all(x == config.multiDepthFeatures[0] for x in config.multiDepthFeatures):
                raise ValueError("multiDepthFeatures have to be identical for sample "
                                 "placement to work")
            from ..utils.sample_placement_tracker import SamplePlacementTracker
            self.sample_placement_tracker = SamplePlacementTracker(
                self.num_items, self.w, self.h, max_sample_count=config.multiDepthFeatures[0])
            ckpt = os.path.join(sp_dir, set_name, f"{config.numRaymarchSamples[-1]}.ckpt.npy")
            if os.path.exists(ckpt):
                self.sample_placement_tracker.load(ckpt)

    def __len__(self):
        return self.num_items

    def _color_image(self, img: np.ndarray, file_name: str) -> np.ndarray:
        img = img.astype(np.float32)
        if self.scale > 1:
            img = _scale_image(img, self.scale)
        if img.shape[0] != self.h or img.shape[1] != self.w:
            raise ValueError(
                f"{file_name}: image size mismatch: expected {self.w}x{self.h}, got "
                f"{img.shape[1]}x{img.shape[0]}")
        return (img / 255.0)[:, :, :3]

    def transform_depth_image(self, depth_image: np.ndarray,
                              do_not_transform=False) -> np.ndarray:
        """Normalize a raw world-depth map: median downscale, depth-ignore
        masking, distance adjustment, depth-transform warp into [0,1]."""
        depth_image = depth_image.astype(np.float32)
        depth_image = np.resize(depth_image, (self.h * self.scale, self.w * self.scale))
        if self.flip_depth and not do_not_transform:
            depth_image = np.flip(depth_image, 0)

        depth_only_max = depth_image.copy()
        depth_only_max[depth_only_max != self.depth_ignore] = 0
        depth_only_max = _scale_image(depth_only_max, self.scale) \
            if self.scale > 1 else depth_only_max

        if self.scale > 1:
            interp = self.config.scaleInterpolation
            if interp == "area":
                depth_image = _scale_image(depth_image, self.scale)
            elif interp == "median":
                stacked = [depth_image[i::self.scale, j::self.scale]
                           for i in range(self.scale) for j in range(self.scale)]
                depth_sorted = np.sort(np.dstack(stacked), -1)
                depth_image = depth_sorted[:, :, self.scale - 1]
            else:  # leaveOut
                depth_image = depth_image[0::self.scale, 0::self.scale]

        depth_image[depth_only_max != 0] = self.depth_ignore
        if do_not_transform:
            return depth_image.reshape(1, self.h, self.w, 1)

        if self.depth_distance_adjustment:
            depth_image = depth_image / self.base_ray_z

        depth_image = (depth_image - self.depth_range[0]) / \
            (self.depth_range[1] - self.depth_range[0])
        depth_image = self.depth_transform.from_world(
            depth_transforms_mod.LinearTransform.to_world(depth_image, self.depth_range),
            self.depth_range)
        depth_image = np.asarray(depth_image)
        depth_image[depth_only_max != 0] = 1.0
        return depth_image.reshape(1, self.h, self.w, 1)

    def load_depth_image(self, file_name: str) -> np.ndarray:
        with np.load(file_name) as np_file:
            depth = np_file["depth"] if "depth" in np_file.files else np_file[np_file.files[0]]
        return self.transform_depth_image(depth)

    def load_exported_nerf_depth(self, file_name: str) -> np.ndarray:
        """Depth from an exported NeRF run's quantized-weights dump: the
        reference's torch container (``OutputDepthMap``, ``InputDepthRange``),
        or an npz with the same keys, re-warped from the exported range."""
        from ..utils.torch_ckpt import load_tensor_dict
        d = load_tensor_dict(file_name, ("OutputDepthMap", "InputDepthRange"))
        raw = self.transform_depth_image(d["OutputDepthMap"], do_not_transform=True)
        return np.asarray(self.depth_transform.from_world(raw, d["InputDepthRange"]))


def load_dataset_split(config, dataset_info, set_name, num_samples=2048,
                       load_images=True):
    """A split fully loaded to host memory. (The JAX package streams splits
    that do not fit its host budget; that policy is not ported yet.)"""
    return ViewCellDataset(config, dataset_info, set_name, num_samples, load_images)
