"""The feature pipeline: turns (pose, rotation, per-pixel dirs) into encoded
MLP inputs, and network outputs into composited radiance.

Counterpart of ``adanerf_tpu/pipeline/features.py``. Feature sets hold the
scene's constants; ``batch`` and ``postprocess`` are PyTorch functions over
tensors on the batch's device, differentiable where the JAX versions are.
The adaptive path keeps the static (rays, S) shape with a validity mask.

Every feature set of the JAX registry is ported: the targets
``RGBARayMarch``, ``ClassifiedDepth``, ``Raw`` and ``RawSigmoid``; the
inputs ``SpherePosDir``, ``CamPosDir``, ``RayMarchFromPoses`` (every
sampler of ``ops/samplers.py``) and ``RayMarchFromCoarse`` (nerf-pytorch's
hierarchical fine stage).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from ..ops import samplers as S
from ..ops.encoding import get_encoder
from ..ops.normalization import get_normalization, get_normalization_abbr
from ..ops.raymarch import (adaptive_raw2outputs_masked, ndc_rays, nerf_raw2outputs,
                            ray_sphere_offset, sample_pdf)
from .keys import FSK, DatasetKeys


@dataclass(frozen=True)
class SceneStatic:
    """Per-scene constants every stage needs."""
    w: int
    h: int
    fov: float
    focal: float
    view_cell_center: Tuple[float, float, float]
    view_cell_radius: float
    depth_range: Tuple[float, float]
    depth_range_warped: Tuple[float, float]
    depth_transform: Any  # LogTransform / LinearTransform / NoneTransform
    depth_max: float


def _sampler_transform(config, net_idx: int):
    """Oracle-output transform keyed on the upstream loss: BCE -> sigmoid,
    CE -> softmax."""
    if net_idx <= 0:
        return None
    loss = config.losses[net_idx - 1]
    if loss == "BCEWithLogitsLoss":
        return torch.sigmoid
    if loss == "CrossEntropyLoss":
        return lambda d: torch.softmax(d, dim=-1)
    if loss == "CrossEntropyLossWeighted":
        disc = config.multiDepthFeatures[net_idx] if config.multiDepthFeatures else 128
        return lambda d: torch.softmax(d[..., :disc], dim=-1)
    return None


def _freqs(config, net_idx: int):
    if config.posEncArgs[net_idx] == "none":
        return -1, -1
    pos, dirs = (int(v) for v in config.posEncArgs[net_idx].split('-'))
    return pos, dirs


class FeatureSet:
    """Base protocol: ``batch`` consumes a DatasetKeys dict of tensors,
    ``postprocess`` consumes and extends the inference dict."""
    abbr = "Unknown"
    n_feat = 0
    net_idx = -1

    def constant(self, name, device, make):
        """The constant tensor ``name`` on ``device``, made by ``make()``
        once: a copy from host memory would wait for the device to finish
        its queued work, every step."""
        consts = self.__dict__.setdefault("_constants", {})
        key = (name, str(device))
        if key not in consts:
            consts[key] = make().to(device)
        return consts[key]

    def batch(self, data, prev_outs=None, is_inference=False, generator=None):
        return None

    def postprocess(self, inference_dict, data):
        inference_dict[FSK.postprocessed_network_output] = \
            inference_dict[FSK.network_output]

    def get_string(self):
        return self.abbr


# ---------------------------------------------------------------------------
# output feature sets (training targets)
# ---------------------------------------------------------------------------

class RGBARayMarch(FeatureSet):
    """Target = ground-truth pixel colours."""
    abbr = "RGBARayMarch"
    n_feat = 4

    def __init__(self, config=None, net_idx=-1, scene: SceneStatic = None):
        self.net_idx = net_idx


class Raw(FeatureSet):
    """No target; defines the oracle's output width."""
    n_feat = 128

    def __init__(self, config=None, net_idx=-1, scene: SceneStatic = None):
        if config is not None and config.multiDepthFeatures:
            self.n_feat = config.multiDepthFeatures[net_idx]
        self.net_idx = net_idx
        self.abbr = f"R-{self.n_feat}"


class RawSigmoid(Raw):
    """Same as Raw. Its sigmoid postprocess exists for parity, but the
    cascade (like the reference's) only runs the input feature sets'
    postprocess, so downstream consumers see the raw oracle output."""

    def __init__(self, config=None, net_idx=-1, scene: SceneStatic = None):
        super().__init__(config, net_idx, scene)
        self.abbr = f"S-{self.n_feat}"

    def postprocess(self, inference_dict, data):
        inference_dict[FSK.postprocessed_network_output] = \
            torch.sigmoid(inference_dict[FSK.network_output])


class ClassifiedDepth(FeatureSet):
    """The GT-depth oracle's target: per sampled pixel, the window_size^2
    neighbourhood of the GT depth map, discretized into n_feat bins, the
    largest distance weight kept per bin. The numbers of the JAX trainer's
    target (``adanerf_tpu/native/disc_depth.py``, its C library or numpy
    fallback), built on the batch's device. A depth window
    (``multiDepthWindowSize`` ``w:d``) names the run, as in JAX, and, as
    in the JAX trainer's target, is not applied."""
    n_feat = 128

    def __init__(self, config=None, net_idx=-1, scene: SceneStatic = None):
        self.window_size = 5
        self.d_window_size = 0
        self.ignore_depth_value = 1.0
        if config is not None:
            if config.multiDepthFeatures:
                self.n_feat = config.multiDepthFeatures[net_idx]
            if config.multiDepthWindowSize:
                sizes = config.multiDepthWindowSize[net_idx].split(':')
                self.window_size = int(sizes[0])
                if len(sizes) > 1:
                    self.d_window_size = int(sizes[1])
            if config.multiDepthIgnoreValue:
                self.ignore_depth_value = config.multiDepthIgnoreValue[net_idx]
        self.center_id = self.window_size // 2
        self.net_idx = net_idx
        self.w = scene.w if scene else 0
        self.h = scene.h if scene else 0
        if self.d_window_size > 1:
            if self.d_window_size % 2 == 0:
                self.d_window_size += 1
            self.abbr = f"CD-{self.n_feat}-{self.window_size}-{self.d_window_size}"
        else:
            self.abbr = f"CD-{self.n_feat}-{self.window_size}"

    def features_from_depth(self, depths: torch.Tensor, sample_indices: torch.Tensor):
        """depths: the GT depth maps of n_img images (any shape of n_img * h
        * w elements); sample_indices: (n_img, n) or, for one image, (n,)
        flat pixel indices ``y * w + x``. Returns (n_img * n, n_feat)
        float32, image-major: per bin the largest ``1 - dist / ((window //
        2 + 1) sqrt 2)`` over the window's pixels (clamped at the border)
        whose depth lies below the ignore value, a one-hot of the pixel's
        bin for window 1. The whole window in one gather and one max-scatter:
        a loop over its pixels would launch hundreds of small kernels."""
        maps = depths.reshape(-1, self.h * self.w)
        idx = sample_indices.reshape(maps.shape[0], -1).long()
        dev = depths.device
        offsets = torch.arange(self.window_size, device=dev) - self.center_id
        x = ((idx % self.w)[..., None, None] + offsets[:, None]).clamp(0, self.w - 1)
        y = ((idx // self.w)[..., None, None] + offsets[None, :]).clamp(0, self.h - 1)
        val = torch.gather(maps, 1, (y * self.w + x).reshape(maps.shape[0], -1))
        val = val.reshape(-1, self.window_size ** 2)   # window pixel (i, j) at x + i, y + j
        grid = np.arange(self.window_size) - self.center_id
        max_dist = (self.window_size // 2 + 1) * math.sqrt(2.0)
        weight = torch.as_tensor(
            (1.0 - np.sqrt(grid[:, None] ** 2 + grid[None, :] ** 2) / max_dist).reshape(-1),
            dtype=torch.float32, device=dev)
        disc = (val / (1.0 / self.n_feat)).to(torch.int32)
        valid = (val < self.ignore_depth_value) & (disc >= 0)
        feats = torch.zeros((val.shape[0], self.n_feat), dtype=torch.float32, device=dev)
        return feats.scatter_reduce_(1, disc.clamp(0, self.n_feat - 1).long(), weight * valid,
                                     reduce="amax")


# ---------------------------------------------------------------------------
# input feature sets
# ---------------------------------------------------------------------------

class SpherePosDir(FeatureSet):
    """Oracle input: ray direction encoding + view-cell-sphere exit point
    encoding."""
    base_abbr = "SpPoDi"
    project = True  # the position is where the ray leaves the view-cell sphere

    def __init__(self, config=None, net_idx=-1, scene: SceneStatic = None):
        self.net_idx = net_idx
        self.scene = scene
        self.abbr = self.base_abbr
        self.n_freq_pos, self.n_freq_dir = _freqs(config, net_idx)
        self.enc_type = config.posEnc[net_idx]
        self.pos_enc = get_encoder(self.enc_type, self.n_freq_pos)
        self.dir_enc = get_encoder(self.enc_type, self.n_freq_dir)
        self.additional_samples = config.raySampleInput[net_idx] if config.raySampleInput else 0
        if self.enc_type == "nerf":
            if self.additional_samples != 0:
                self.n_feat = ((self.additional_samples * 3 + 3) * (self.n_freq_pos * 2 + 1)
                               + 3 + self.n_freq_dir * 3 * 2)
            else:
                self.n_feat = self.n_freq_pos * 6 + 3 + 3 + self.n_freq_dir * 6
        else:
            self.n_feat = 6 + self.additional_samples * 3
        if self.additional_samples != 0:
            self.abbr = ("SpPoDir" if self.project else self.base_abbr) + \
                f"[{self.additional_samples}]"

    def batch(self, data, prev_outs=None, is_inference=False, generator=None):
        poses = data[DatasetKeys.image_pose]          # (n_img, 3)
        rotations = data[DatasetKeys.image_rotation]  # (n_img, 3, 3)
        directions = data[DatasetKeys.ray_directions_samples]  # (n_img, R, 3)
        sc = self.scene
        dev = directions.device

        n_img, n_rays = directions.shape[0], directions.shape[1]
        nds_flat = torch.einsum('bij,bnj->bni', rotations, directions).reshape(-1, 3)
        origins = poses[:, None, :].expand(n_img, n_rays, 3).reshape(-1, 3)  # image-major
        proj_points = origins
        if self.project:
            center = self.constant("center", dev, lambda: torch.tensor(sc.view_cell_center))
            distance = ray_sphere_offset(nds_flat, origins, center, sc.view_cell_radius)
            proj_points = origins + nds_flat * distance[:, None]

        enc_dirs = self.dir_enc(nds_flat / torch.linalg.vector_norm(nds_flat, dim=-1,
                                                                     keepdim=True))
        parts = [enc_dirs, self.pos_enc(proj_points)]
        if self.additional_samples != 0:
            step = 1.0 / self.additional_samples
            z_unit = torch.linspace(step / 2, 1.0 - step / 2, self.additional_samples,
                                    device=dev)
            z_world = sc.depth_transform.to_world(z_unit, sc.depth_range_warped)
            add = proj_points[:, None, :] + nds_flat[:, None, :] * z_world[None, :, None]
            enc_add = self.pos_enc(add / sc.depth_range_warped[1])
            enc_add = torch.cat([enc_add[..., :3] * sc.depth_range_warped[1],
                                 enc_add[..., 3:]], dim=-1)
            parts.append(enc_add.reshape(add.shape[0], -1))

        ret = {FSK.input_feature_batch: torch.cat(parts, dim=-1),
               FSK.input_feature_ray_origins: proj_points,
               FSK.input_feature_ray_directions: nds_flat,
               FSK.input_depth_range: self.constant(
                   "depth_range", dev, lambda: torch.tensor(sc.depth_range_warped))}
        if not is_inference and DatasetKeys.depth_image_samples in data:
            d = data[DatasetKeys.depth_image_samples]
            ret[FSK.input_depth_groundtruth] = d
            ret[FSK.input_depth_groundtruth_world] = \
                sc.depth_transform.to_world(d, sc.depth_range_warped)
        return ret


class CamPosDir(SpherePosDir):
    """Oracle input for NDC scenes: the camera position and the ray
    direction, as ``SpherePosDir`` without the sphere projection."""
    base_abbr = "CaPoDi"
    project = False


SAMPLERS = ("LinearlySpacedZNearZFar", "LinearlySpacedZNearZFarNoDepthRange",
            "UnitSphereLinearOutsideLog", "LinearlySpacedFromDepth",
            "LinearlySpacedFromDepthNoDepthRange", "FromDepthCells",
            "LinearlySpacedFromMultiDepth", "FromIterativeSamplePlacement", "FromClassifiedDepth",
            "FromClassifiedDepthAdaptive", "FromClassifiedDepthAdaptiveNoDepthRange")


class RayMarchFromPoses(FeatureSet):
    """Shading-net input: place z samples (a linspace, around a depth, from
    the oracle's bins, or the adaptive select), encode the ray sample
    positions + dirs; postprocess composites (masked where the sampler is
    adaptive, nerf-pytorch's ``raw2outputs`` otherwise)."""
    abbr = "RayMarchFromPoses"

    def __init__(self, config=None, net_idx=-1, scene: SceneStatic = None):
        self.net_idx = net_idx
        self.scene = scene
        self.n_ray_samples = config.numRaymarchSamples[net_idx]
        self.z_near = 0.001 if not config.zNear else config.zNear[net_idx]
        self.z_far = 1.0 if not config.zFar else config.zFar[net_idx]
        self.train_with_gt_depth = config.trainWithGTDepth
        self.deterministic_sampling = config.deterministicSampling
        self.noise_amplitude = 0.0 if not config.rayMarchSamplingNoise \
            else config.rayMarchSamplingNoise[net_idx]
        self.z_step = ((self.z_far - self.z_near) / self.n_ray_samples
                       if not config.rayMarchSamplingStep
                       else config.rayMarchSamplingStep[net_idx])
        self.sampler_name = config.rayMarchSampler[net_idx]
        if self.sampler_name not in SAMPLERS:
            raise ValueError(f"unknown sampler {self.sampler_name} (known: {list(SAMPLERS)})")
        self.use_ndc = config.useNDC is True
        self.adaptive = "Adaptive" in self.sampler_name
        self.threshold = config.adaptiveSamplingThreshold
        self.remapping = self.threshold > 0.0
        self.accumulation_mult = config.accumulationMult or None
        self.perturb = config.perturb
        self.norm_center = config.rayMarchNormalizationCenter
        self.disc = config.multiDepthFeatures[net_idx] if config.multiDepthFeatures else 128
        self.oracle_transform = _sampler_transform(config, net_idx)
        self.is_first_loss_oracle = (len(config.losses) > 0
                                     and config.losses[0] == "NeRFWeightMultiplicationLoss")

        norm_name = config.rayMarchNormalization[net_idx] \
            if config.rayMarchNormalization else None
        self.normalization = get_normalization(norm_name)
        self.abbr = self.abbr + get_normalization_abbr(norm_name)

        self.n_freq_pos, self.n_freq_dir = _freqs(config, net_idx)
        self.enc_type = config.posEnc[net_idx]
        self.pos_enc = get_encoder(self.enc_type, self.n_freq_pos)
        self.dir_enc = get_encoder(self.enc_type, self.n_freq_dir)
        self.n_feat = (self.n_freq_pos * 6 + 3 + 3 + self.n_freq_dir * 6
                       if self.enc_type == "nerf" else 6)
        # the warped depth range from the first SpherePosDir stage onward
        self.depth_range = None
        if scene is not None:
            warped = any(f == "SpherePosDir" for f in config.inFeatures[:net_idx + 1])
            self.depth_range = scene.depth_range_warped if warped else scene.depth_range

    def sampler_print_name(self) -> str:
        """Sampler part of the experiment directory's name."""
        n = self.sampler_name
        near_far = f"{self.z_near}_{self.z_far}_{self.n_ray_samples}"
        noisy = f"{self.z_step}_{self.noise_amplitude}"
        if n in ("FromClassifiedDepthAdaptive", "FromClassifiedDepthAdaptiveNoDepthRange"):
            return f"{self.n_ray_samples}_LSfCDA_({self.threshold})_{self.disc}_" \
                f"{self.noise_amplitude}"
        if n == "FromClassifiedDepth":
            return f"{self.n_ray_samples}_LSfCD_{self.disc}_{self.noise_amplitude}"
        if n == "LinearlySpacedFromMultiDepth":
            return f"{near_far}_LSfMD_{noisy}"
        if n == "FromDepthCells":
            return f"fDC_{self.n_ray_samples}_FromDepthCells_{noisy}"
        if n == "FromIterativeSamplePlacement":
            return f"Iter_{near_far}_{n}_{noisy}"
        if n in ("LinearlySpacedZNearZFar", "LinearlySpacedZNearZFarNoDepthRange",
                 "UnitSphereLinearOutsideLog") and self.noise_amplitude <= 0.0:
            return f"{near_far}_{n}"
        return f"{near_far}_{n}_{noisy}"

    def get_string(self):
        ret = self.abbr + f"[{self.sampler_print_name()}]"
        if self.accumulation_mult:
            ret += f"_acc_{self.accumulation_mult}"
        return ret

    def _generate_z(self, n_rays, depth, det, generator, ray_origins, ray_directions,
                    sample_placement, device):
        """z per (ray, slot) of the configured sampler: a tensor, or (z,
        probs, mask) from the adaptive select."""
        dr, dtf, name = self.depth_range, self.scene.depth_transform, self.sampler_name
        noise = dict(z_step=self.z_step, noise_amplitude=self.noise_amplitude)

        def linspace(world):  # the same z on every ray and step: made once
            def make():
                z = S.linearly_spaced_z(1, self.z_near, self.z_far, self.n_ray_samples)[0]
                return dtf.to_world(z, dr) if world else z
            return self.constant("z", device, make).expand(n_rays, self.n_ray_samples)

        if name in ("LinearlySpacedZNearZFarNoDepthRange", "LinearlySpacedZNearZFar"):
            world = name == "LinearlySpacedZNearZFar"
            if det or self.noise_amplitude <= 0.0 or generator is None:
                return linspace(world)
            z = S.linearly_spaced_z(n_rays, self.z_near, self.z_far, self.n_ray_samples,
                                    det=det, generator=generator, device=device, **noise)
            return dtf.to_world(z, dr) if world else z
        if name == "UnitSphereLinearOutsideLog":
            return S.unit_sphere_linear_outside_log(ray_origins, ray_directions, n_rays,
                                                    self.z_near, self.z_far,
                                                    self.n_ray_samples, dr)
        if name in ("LinearlySpacedFromDepthNoDepthRange", "LinearlySpacedFromDepth"):
            return S.linearly_spaced_from_depth(depth, self.n_ray_samples, depth_range=dr,
                                                depth_transform=dtf,
                                                to_world=not name.endswith("NoDepthRange"),
                                                generator=generator, **noise)
        if name == "FromDepthCells":
            return S.from_depth_cells(depth, self.n_ray_samples, disc=self.disc, depth_range=dr,
                                      depth_transform=dtf, generator=generator, **noise)
        if name == "LinearlySpacedFromMultiDepth":
            return S.linearly_spaced_from_multi_depth(depth, self.n_ray_samples, depth_range=dr,
                                                      depth_transform=dtf, generator=generator,
                                                      **noise)
        if name == "FromIterativeSamplePlacement":
            return S.from_iterative_sample_placement(sample_placement, self.n_ray_samples,
                                                     dr, dtf)
        if name == "FromClassifiedDepth":
            return S.from_classified_depth(depth, self.n_ray_samples, dr, dtf, det=det,
                                           generator=generator, transform=self.oracle_transform)
        if name in ("FromClassifiedDepthAdaptive", "FromClassifiedDepthAdaptiveNoDepthRange"):
            no_range = name.endswith("NoDepthRange")
            if self.threshold == 0.0:
                return linspace(not no_range)
            d = depth
            if self.oracle_transform is not None:
                d = self.oracle_transform(d.detach())
            z_unit, z_probs, mask = S.adaptive_select(d, self.n_ray_samples, self.threshold)
            z_world = z_unit if no_range else dtf.to_world(z_unit, dr)
            return z_world, z_probs, mask
        raise AssertionError(name)  # __init__ takes the SAMPLERS only

    def batch(self, data, prev_outs=None, is_inference=False, generator=None):
        poses = data[DatasetKeys.image_pose]
        rotations = data[DatasetKeys.image_rotation]
        directions = data[DatasetKeys.ray_directions_samples]
        sc = self.scene
        dev = directions.device

        n_rays_per_img = directions.shape[1]
        n_rays = directions.shape[0] * n_rays_per_img
        depth_image = data.get(DatasetKeys.depth_image_samples)
        sample_placement = data.get(DatasetKeys.sample_placement)

        depth = z_probs = None
        if prev_outs and (not self.train_with_gt_depth or is_inference):
            depth = prev_outs[-1][FSK.postprocessed_network_output]
        elif depth_image is not None and (not is_inference or not prev_outs):
            depth = depth_image

        ray_origins = ray_directions = None
        if prev_outs:
            ray_origins = prev_outs[-1].get(FSK.input_feature_ray_origins)
            ray_directions = prev_outs[-1].get(FSK.input_feature_ray_directions)
        if ray_directions is None:
            ray_directions = torch.einsum('bij,bnj->bni', rotations, directions).reshape(-1, 3)
        rays_d = ray_directions
        if ray_origins is None:
            ray_origins = poses[:, None, :].expand(-1, n_rays_per_img, 3).reshape(-1, 3)

        if self.use_ndc:
            ray_origins, rays_d = ndc_rays(sc.h, sc.w, sc.focal, 1.0, ray_origins, ray_directions)
            ray_directions = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)

        det = self.deterministic_sampling or is_inference
        z_out = self._generate_z(n_rays, depth, det, generator, ray_origins, ray_directions,
                                 sample_placement, dev)
        mask = None
        if isinstance(z_out, tuple):
            z_vals, z_probs, mask = z_out
        else:
            z_vals = z_out
        if self.perturb and not is_inference and generator is not None:
            z_vals = S.perturb_z(z_vals, generator)

        # dead adaptive slots carry inf z: a finite dummy keeps the masked-out
        # MLP inputs NaN-free
        z_pos = torch.where(mask, z_vals, torch.ones_like(z_vals)) if mask is not None else z_vals
        positions = ray_origins[:, None, :] + rays_d[:, None, :] * z_pos[..., None]
        center = self.constant("center", dev, lambda: torch.tensor(
            self.norm_center if len(self.norm_center) == 3 else sc.view_cell_center))
        positions = self.normalization(positions, center, sc.depth_max)

        s_dim = positions.shape[1]
        embedded = self.pos_enc(positions.reshape(-1, 3))
        dirs_exp = ray_directions[:, None, :].expand(positions.shape)
        embedded = torch.cat([embedded, self.dir_enc(dirs_exp.reshape(-1, 3))], dim=-1)
        embedded = embedded.reshape(n_rays, s_dim, -1)

        ret = {FSK.input_feature_batch: embedded,
               FSK.nerf_input_feature_z_vals: z_vals,
               FSK.nerf_input_feature_ray_directions: rays_d,
               FSK.nerf_input_feature_ray_origins: ray_origins,
               FSK.input_depth_range: self.constant(
                   "depth_range", dev, lambda: torch.tensor(self.depth_range)),
               FSK.input_depth: depth}
        if mask is not None:
            ret[FSK.adaptive_sample_mask] = mask
        if not is_inference and depth_image is not None:
            ret[FSK.input_depth_groundtruth] = depth_image
            ret[FSK.input_depth_groundtruth_world] = \
                sc.depth_transform.to_world(depth_image, self.depth_range)
        if self.is_first_loss_oracle:
            ret[FSK.oracle_weights] = depth if z_probs is None else z_probs
        return ret

    def postprocess(self, inference_dict, data):
        raw = inference_dict[FSK.network_output]
        z_vals = inference_dict[FSK.nerf_input_feature_z_vals]
        depth = inference_dict.get(FSK.oracle_weights)
        if self.adaptive:
            mask = inference_dict.get(FSK.adaptive_sample_mask)
            if mask is None:
                mask = torch.ones(z_vals.shape, dtype=torch.bool, device=z_vals.device)
            rgb_map, _disp, _acc, weights, depth_map, alpha = adaptive_raw2outputs_masked(
                raw, z_vals, mask, depth=depth, accumulation_mult=self.accumulation_mult)
            if self.remapping:
                # fraction of active samples per ray
                inference_dict[FSK.adaptive_sample_positions] = \
                    torch.sum(mask, dim=1) / self.n_ray_samples
        else:
            rays_d = inference_dict[FSK.nerf_input_feature_ray_directions]
            rgb_map, _disp, _acc, weights, depth_map, alpha = nerf_raw2outputs(
                raw.reshape(rays_d.shape[0], z_vals.shape[1], -1), z_vals, rays_d,
                depth=depth, accumulation_mult=self.accumulation_mult)
        sc = self.scene
        inference_dict[FSK.postprocessed_network_output] = rgb_map
        inference_dict[FSK.nerf_weights_output] = weights
        inference_dict[FSK.nerf_alpha_output] = alpha
        if self.use_ndc:
            inference_dict[FSK.nerf_estimated_depth] = depth_map.reshape(-1, 1)
        else:
            inference_dict[FSK.nerf_estimated_depth] = \
                sc.depth_transform.from_world(depth_map, self.depth_range).reshape(-1, 1)


class RayMarchFromCoarse(FeatureSet):
    """nerf-pytorch's hierarchical fine stage: inverse-CDF samples of the
    coarse stage's weights between its sample midpoints, without gradient,
    merged with the coarse z and sorted; the coarse stage's rays."""
    abbr = "RayMarchFromCoarse"

    def __init__(self, config=None, net_idx=-1, scene: SceneStatic = None):
        self.net_idx = net_idx
        self.scene = scene
        self.n_ray_samples = config.numRaymarchSamples[net_idx]
        self.z_near = config.zNear[net_idx]
        self.z_far = config.zFar[net_idx]
        self.perturb = config.perturb
        norm_name = config.rayMarchNormalization[net_idx] \
            if config.rayMarchNormalization else None
        self.normalization = get_normalization(norm_name)
        self.abbr = self.abbr + get_normalization_abbr(norm_name)
        self.n_freq_pos, self.n_freq_dir = _freqs(config, net_idx)
        self.enc_type = config.posEnc[net_idx]
        self.pos_enc = get_encoder(self.enc_type, self.n_freq_pos)
        self.dir_enc = get_encoder(self.enc_type, self.n_freq_dir)
        self.n_feat = (self.n_freq_pos * 6 + 3 + 3 + self.n_freq_dir * 6
                       if self.enc_type == "nerf" else 6)
        self.depth_range = scene.depth_range if scene else (0.0, 1.0)

    def get_string(self):
        return self.abbr + f"[{self.z_near}_{self.z_far}_{self.n_ray_samples}]"

    def batch(self, data, prev_outs=None, is_inference=False, generator=None):
        if not prev_outs:
            raise ValueError(f"feature {self.abbr} requires prev_outs")
        p = prev_outs[-1]
        prev_z = p[FSK.nerf_input_feature_z_vals]
        ray_origins = p[FSK.nerf_input_feature_ray_origins]
        ray_directions = p[FSK.nerf_input_feature_ray_directions]
        sc = self.scene
        dev = prev_z.device

        with torch.no_grad():  # the samples carry no gradient, as JAX stops it
            z_mid = 0.5 * (prev_z[..., 1:] + prev_z[..., :-1])
            z_samples = sample_pdf(z_mid, p[FSK.nerf_weights_output][..., 1:-1],
                                   self.n_ray_samples,
                                   det=(not self.perturb) or is_inference, generator=generator)
        z_vals = torch.sort(torch.cat([prev_z, z_samples], dim=-1), dim=-1).values

        positions = ray_origins[..., None, :] + ray_directions[..., None, :] * z_vals[..., :, None]
        center = self.constant("center", dev, lambda: torch.tensor(sc.view_cell_center))
        positions = self.normalization(positions, center, sc.depth_max)
        s_dim = positions.shape[1]
        embedded = self.pos_enc(positions.reshape(-1, 3))
        dirs_exp = ray_directions[:, None, :].expand(positions.shape)
        embedded = torch.cat([embedded, self.dir_enc(dirs_exp.reshape(-1, 3))], dim=-1)
        embedded = embedded.reshape(ray_directions.shape[0], s_dim, -1)
        return {FSK.input_feature_batch: embedded,
                FSK.nerf_input_feature_z_vals: z_vals,
                FSK.nerf_input_feature_ray_directions: ray_directions,
                FSK.nerf_input_feature_ray_origins: ray_origins,
                FSK.input_depth_range: self.constant(
                    "depth_range", dev, lambda: torch.tensor(self.depth_range))}

    def postprocess(self, inference_dict, data):
        raw = inference_dict[FSK.network_output]
        rays_d = inference_dict[FSK.nerf_input_feature_ray_directions]
        z_vals = inference_dict[FSK.nerf_input_feature_z_vals]
        rgb_map, _disp, _acc, weights, depth_map, alpha = nerf_raw2outputs(
            raw.reshape(rays_d.shape[0], z_vals.shape[1], -1), z_vals, rays_d)
        inference_dict[FSK.postprocessed_network_output] = rgb_map
        inference_dict[FSK.nerf_weights_output] = weights
        inference_dict[FSK.nerf_alpha_output] = alpha
        inference_dict[FSK.nerf_estimated_depth] = \
            self.scene.depth_transform.from_world(depth_map, self.depth_range).reshape(-1, 1)


_IN_FEATURES = {"SpherePosDir": SpherePosDir, "CamPosDir": CamPosDir,
                "RayMarchFromPoses": RayMarchFromPoses,
                "RayMarchFromCoarse": RayMarchFromCoarse}
_OUT_FEATURES = {"ClassifiedDepth": ClassifiedDepth, "RGBARayMarch": RGBARayMarch,
                 "Raw": Raw, "RawSigmoid": RawSigmoid}


def get_feature_sets(config, scene: SceneStatic):
    """Config strings -> feature instances."""
    f_in, f_out = [], []
    for i in range(len(config.inFeatures)):
        for name, table in ((config.inFeatures[i], _IN_FEATURES),
                            (config.outFeatures[i], _OUT_FEATURES)):
            if name not in table:
                raise ValueError(f"unknown feature set {name} (known: {sorted(table)})")
        f_in.append(_IN_FEATURES[config.inFeatures[i]](config=config, net_idx=i, scene=scene))
        f_out.append(_OUT_FEATURES[config.outFeatures[i]](config=config, net_idx=i, scene=scene))
    return f_in, f_out
