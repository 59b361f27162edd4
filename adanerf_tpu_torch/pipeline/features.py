"""The feature pipeline: turns (pose, rotation, per-pixel dirs) into encoded
MLP inputs, and network outputs into composited radiance.

Counterpart of ``adanerf_tpu/pipeline/features.py``. Feature sets hold the
scene's constants; ``batch`` and ``postprocess`` are PyTorch functions over
tensors on the batch's device, differentiable where the JAX versions are.
The adaptive path keeps the static (rays, S) shape with a validity mask.

Ported: ``RGBARayMarch``, ``Raw``, ``RawSigmoid``, ``SpherePosDir`` and
``RayMarchFromPoses`` with the ``FromClassifiedDepthAdaptive`` samplers (the
dense threshold-0 linspace and the adaptive select). The other feature sets
and samplers raise ``NotImplementedError`` (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from ..ops import samplers as S
from ..ops.encoding import get_encoder
from ..ops.normalization import get_normalization, get_normalization_abbr
from ..ops.raymarch import adaptive_raw2outputs_masked, ndc_rays, ray_sphere_offset
from .keys import FSK, DatasetKeys

_NOT_PORTED = "is not ported yet (ROADMAP Queue 1, item 8)"


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


# ---------------------------------------------------------------------------
# input feature sets
# ---------------------------------------------------------------------------

class SpherePosDir(FeatureSet):
    """Oracle input: ray direction encoding + view-cell-sphere exit point
    encoding."""

    def __init__(self, config=None, net_idx=-1, scene: SceneStatic = None):
        self.net_idx = net_idx
        self.scene = scene
        self.abbr = "SpPoDi"
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
            self.abbr = f"SpPoDir[{self.additional_samples}]"

    def batch(self, data, prev_outs=None, is_inference=False, generator=None):
        poses = data[DatasetKeys.image_pose]          # (n_img, 3)
        rotations = data[DatasetKeys.image_rotation]  # (n_img, 3, 3)
        directions = data[DatasetKeys.ray_directions_samples]  # (n_img, R, 3)
        sc = self.scene
        dev = directions.device

        n_img, n_rays = directions.shape[0], directions.shape[1]
        nds_flat = torch.einsum('bij,bnj->bni', rotations, directions).reshape(-1, 3)
        center = self.constant("center", dev, lambda: torch.tensor(sc.view_cell_center))
        origins = poses[:, None, :].expand(n_img, n_rays, 3).reshape(-1, 3)  # image-major
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


class RayMarchFromPoses(FeatureSet):
    """Shading-net input: place z samples (dense or adaptive), encode the ray
    sample positions + dirs; postprocess composites."""
    abbr = "RayMarchFromPoses"

    def __init__(self, config=None, net_idx=-1, scene: SceneStatic = None):
        self.net_idx = net_idx
        self.scene = scene
        self.n_ray_samples = config.numRaymarchSamples[net_idx]
        self.z_near = 0.001 if not config.zNear else config.zNear[net_idx]
        self.z_far = 1.0 if not config.zFar else config.zFar[net_idx]
        self.train_with_gt_depth = config.trainWithGTDepth
        self.noise_amplitude = 0.0 if not config.rayMarchSamplingNoise \
            else config.rayMarchSamplingNoise[net_idx]
        self.sampler_name = config.rayMarchSampler[net_idx]
        if self.sampler_name not in ("FromClassifiedDepthAdaptive",
                                     "FromClassifiedDepthAdaptiveNoDepthRange"):
            raise NotImplementedError(f"sampler {self.sampler_name} {_NOT_PORTED}")
        self.use_ndc = config.useNDC is True
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
        return (f"{self.n_ray_samples}_LSfCDA_({self.threshold})_{self.disc}_"
                f"{self.noise_amplitude}")

    def get_string(self):
        ret = self.abbr + f"[{self.sampler_print_name()}]"
        if self.accumulation_mult:
            ret += f"_acc_{self.accumulation_mult}"
        return ret

    def _generate_z(self, n_rays, depth, device):
        """z per (ray, slot) from the oracle's output ``depth``: the dense
        linspace at threshold 0, else the adaptive select (z, probs, mask)."""
        no_range = self.sampler_name.endswith("NoDepthRange")
        dtf = self.scene.depth_transform
        if self.threshold == 0.0:
            def make():
                z = S.linearly_spaced_z(1, self.z_near, self.z_far, self.n_ray_samples)[0]
                return z if no_range else dtf.to_world(z, self.depth_range)
            return self.constant("z", device, make).expand(n_rays, self.n_ray_samples)
        d = depth
        if self.oracle_transform is not None:
            d = self.oracle_transform(d.detach())
        z_unit, z_probs, mask = S.adaptive_select(d, self.n_ray_samples, self.threshold)
        z_world = z_unit if no_range else dtf.to_world(z_unit, self.depth_range)
        return z_world, z_probs, mask

    def batch(self, data, prev_outs=None, is_inference=False, generator=None):
        poses = data[DatasetKeys.image_pose]
        rotations = data[DatasetKeys.image_rotation]
        directions = data[DatasetKeys.ray_directions_samples]
        sc = self.scene
        dev = directions.device

        n_rays_per_img = directions.shape[1]
        n_rays = directions.shape[0] * n_rays_per_img
        depth_image = data.get(DatasetKeys.depth_image_samples)

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

        z_out = self._generate_z(n_rays, depth, dev)
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
        mask = inference_dict.get(FSK.adaptive_sample_mask)
        if mask is None:
            mask = torch.ones(z_vals.shape, dtype=torch.bool, device=z_vals.device)
        rgb_map, _disp, _acc, weights, depth_map, alpha = adaptive_raw2outputs_masked(
            raw, z_vals, mask, depth=depth, accumulation_mult=self.accumulation_mult)
        if self.remapping:
            # fraction of active samples per ray
            inference_dict[FSK.adaptive_sample_positions] = \
                torch.sum(mask, dim=1) / self.n_ray_samples
        sc = self.scene
        inference_dict[FSK.postprocessed_network_output] = rgb_map
        inference_dict[FSK.nerf_weights_output] = weights
        inference_dict[FSK.nerf_alpha_output] = alpha
        if self.use_ndc:
            inference_dict[FSK.nerf_estimated_depth] = depth_map.reshape(-1, 1)
        else:
            inference_dict[FSK.nerf_estimated_depth] = \
                sc.depth_transform.from_world(depth_map, self.depth_range).reshape(-1, 1)


_IN_FEATURES = {"SpherePosDir": SpherePosDir, "RayMarchFromPoses": RayMarchFromPoses}
_OUT_FEATURES = {"RGBARayMarch": RGBARayMarch, "Raw": Raw, "RawSigmoid": RawSigmoid}


def get_feature_sets(config, scene: SceneStatic):
    """Config strings -> feature instances."""
    f_in, f_out = [], []
    for i in range(len(config.inFeatures)):
        for name, table in ((config.inFeatures[i], _IN_FEATURES),
                            (config.outFeatures[i], _OUT_FEATURES)):
            if name not in table:
                raise NotImplementedError(f"feature set {name} {_NOT_PORTED}")
        f_in.append(_IN_FEATURES[config.inFeatures[i]](config=config, net_idx=i, scene=scene))
        f_out.append(_OUT_FEATURES[config.outFeatures[i]](config=config, net_idx=i, scene=scene))
    return f_in, f_out
