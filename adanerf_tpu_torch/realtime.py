"""Adaptive renderer, plain PyTorch path.

Counterpart of ``adanerf_tpu/realtime.py::RealtimeRenderer``. Per ray batch:

  1. ``_oracle_stage``: rotate the camera-space dirs into the world, take the
     view-cell sphere exit point, encode ``[dir | pos]`` and run the oracle
     MLP; adaptive select on the raw logits gives each ray's depth slots,
     their oracle values and a validity mask. NDC exports move the shading
     rays into NDC space here (the oracle features stay world-space).
  2. ``_shade_stage``: gather only the live (ray, slot) samples, normalize
     and encode them, run the NeRF MLP on that compact batch and scatter the
     raw rgba back by (ray, slot). With ``compaction`` off (or threshold
     <= 0), ``_dense_shade_stage`` instead shades every slot of every ray
     and masks the dead ones.
  3. ``_composite``: front-to-back alpha compositing with the oracle value
     premultiplied into alpha.

These are the plain versions that the hand-written CUDA kernels are held
against: the compacted path for ``ops/kernels/megakernel_compact.py`` (K1),
the dense path for ``ops/kernels/megakernel_dense.py`` (K2). The
TPU-specific workarounds of the JAX stage (segmented scans, one-hot
selects, capacity buckets) become native ``nonzero`` / index ops. Each
MLP runs on its rows padded to a multiple of ``ROWS`` (``mlp_rows``), so a
ray's result depends on its own inputs only, as in the kernels: a frame
renders the same whole or cut into slices (``parallel/render.py``).
"""

from __future__ import annotations

import torch

from .ops.encoding import get_encoder
from .ops.normalization import get_normalization
from .ops.raymarch import ndc_rays, ray_sphere_offset
from .ops.samplers import adaptive_select, linearly_spaced_z

ROWS = 64


def mlp_rows(mlp, x, dtype, post=None):
    """``post(mlp(x, dtype).float())`` on ``x`` padded with zero rows to a
    multiple of ROWS. The CPU's GEMMs pick their kernels by the row count,
    and its vectorized elementwise kernels (``sigmoid``) finish a short
    tail another way, so without the padding a row's result would depend
    on how many rows came with it."""
    n = x.shape[0]
    if n % ROWS:
        x = torch.cat([x, x.new_zeros((ROWS - n % ROWS,) + tuple(x.shape[1:]))])
    y = mlp(x, dtype).float()
    return (y if post is None else post(y))[:n]


def world_dirs(dirs, rotation):
    """(B, 3) world directions ``dirs @ rotation.T``, each product and sum
    rounded in the order K1/K2's ray setup rounds them
    (``csrc/megakernel.cuh::ray_setup``), where a matmul's order would be
    its library's: an NDC sample's shading turns an ulp into a visible
    change."""
    return (dirs[:, 0:1] * rotation[:, 0] + dirs[:, 1:2] * rotation[:, 1]) \
        + dirs[:, 2:3] * rotation[:, 2]


def unit(d):
    """d / |d| along the last axis, |d|^2 summed and clamped at 1e-24 as
    K1/K2 sum and clamp it."""
    return d / torch.sqrt(torch.clamp(d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2]
                                      + d[..., 2:3] * d[..., 2:3], min=1e-24))


class RealtimeRenderer:
    """Compacted adaptive renderer for the AdaNeRF oracle + NeRF cascade.

    oracle, nerf: ``BaseNetDef`` / ``NeRFDef`` modules on ``device``.
    dtype: None for fp32 MLPs, ``torch.bfloat16`` for bf16 operands with
    fp32 accumulation (the production precision of the kernels).
    compaction: shade only the live samples; off (or at threshold <= 0)
    every slot is shaded, as the JAX renderer's ``compaction=False``.
    """

    def __init__(self, oracle, nerf, scene, config, batch_size: int = 65536,
                 dtype=None, device="cuda", compaction: bool = True):
        self.oracle, self.nerf = oracle, nerf
        self.scene, self.config = scene, config
        self.batch_size = batch_size
        self.dtype = dtype
        self.device = torch.device(device)
        self.max_samples = config.numRaymarchSamples[1]
        self.threshold = float(config.adaptiveSamplingThreshold)

        self.use_ndc = getattr(config, "useNDC", False) is True
        sampler1 = ""
        if getattr(config, "rayMarchSampler", None):
            sampler1 = config.rayMarchSampler[1] or ""
        self.z_no_range = self.use_ndc or sampler1.endswith("NoDepthRange")
        self.compaction = compaction and self.threshold > 0.0

        args0 = [int(x) for x in config.posEncArgs[0].split('-')]
        args1 = [int(x) for x in config.posEncArgs[1].split('-')]
        self.enc0_pos = get_encoder(config.posEnc[0], args0[0])
        self.enc0_dir = get_encoder(config.posEnc[0], args0[1])
        self.enc1_pos = get_encoder(config.posEnc[1], args1[0])
        self.enc1_dir = get_encoder(config.posEnc[1], args1[1])
        self.norm_name = config.rayMarchNormalization[1] \
            if config.rayMarchNormalization else None
        self.normalization = get_normalization(self.norm_name)
        self.accumulation_mult = config.accumulationMult or None
        self.center = torch.tensor(scene.view_cell_center, dtype=torch.float32,
                                   device=self.device)

    # -- stage 1+2: features + oracle + adaptive select ----------------------

    def _to_world(self, z):
        if self.z_no_range:
            return z
        return self.scene.depth_transform.to_world(z, self.scene.depth_range_warped)

    def oracle_logits(self, pose, rotation, dirs):
        """dirs: (B, 3) camera-space unit dirs; pose (3,); rotation (3, 3).
        Returns (origins, world dirs, sphere exit points) (B, 3) and the
        oracle's raw per-bin logits (B, D) f32."""
        nds = world_dirs(dirs, rotation)
        origins = pose.expand(nds.shape)
        distance = ray_sphere_offset(nds, origins, self.center, self.scene.view_cell_radius)
        proj = origins + nds * distance[:, None]
        x = torch.cat([self.enc0_dir(nds), self.enc0_pos(proj)], dim=-1)
        return origins, nds, proj, mlp_rows(self.oracle, x, self.dtype)

    def _oracle_stage(self, pose, rotation, dirs):
        """dirs: (B, 3) camera-space unit dirs; pose (3,); rotation (3, 3).
        Returns (o_sh, d_sh, z_world, z_probs, mask): shading-ray origins and
        directions (B, 3), and (B, S) slot depths (0 at dead slots), oracle
        values and validity."""
        sc = self.scene
        origins, nds, proj, oracle_out = self.oracle_logits(pose, rotation, dirs)

        if self.use_ndc:
            o_sh, d_sh = ndc_rays(sc.h, sc.w, sc.focal, 1.0, origins, nds)
        else:
            o_sh, d_sh = proj, nds

        B, S = dirs.shape[0], self.max_samples
        if self.threshold > 0.0:
            z_unit, z_probs, mask = adaptive_select(oracle_out, S, self.threshold)
        else:
            z_unit = linearly_spaced_z(B, 0.001, 1.0, S, device=dirs.device)
            z_probs = torch.sigmoid(oracle_out) if oracle_out.shape[-1] == S \
                else torch.ones_like(z_unit)
            mask = torch.ones(z_unit.shape, dtype=torch.bool, device=dirs.device)
        z_world = torch.where(mask, self._to_world(z_unit), torch.zeros_like(z_unit))
        return o_sh, d_sh, z_world, z_probs, mask

    # -- stage 3: compacted shading + composite ------------------------------

    def _encode_samples(self, pos, dirs):
        p = self.normalization(pos, self.center, self.scene.depth_max)
        return torch.cat([self.enc1_pos(p), self.enc1_dir(dirs)], dim=-1)

    def _composite(self, restored, z_probs):
        """Masked compositing with the oracle premultiply. restored: (B, S, 4)
        sigmoided rgba, zero at dead slots."""
        alpha = restored[..., 3]
        rgb = restored[..., :3]
        if self.accumulation_mult == "alpha":
            alpha = alpha * z_probs
        ones = torch.ones_like(alpha[..., :1])
        trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], -1), dim=-1)[..., :-1]
        weights = alpha * trans
        if self.accumulation_mult == "weights":
            weights = weights * z_probs
        return torch.sum(weights[..., None] * rgb, dim=-2)

    def _shade_stage(self, o_sh, d_sh, z_world, z_probs, mask):
        """Shade only the live samples, then composite. Returns (B, 3)."""
        B, S = mask.shape
        ray, slot = torch.nonzero(mask, as_tuple=True)
        o, d = o_sh[ray], d_sh[ray]
        pos = o + d * z_world[ray, slot][:, None]
        d_enc = d
        if self.use_ndc:
            # NDC rays step with the unnormalized d but encode the unit dir
            d_enc = unit(d)
        restored = torch.zeros((B, S, 4), dtype=torch.float32, device=mask.device)
        restored[ray, slot] = mlp_rows(self.nerf, self._encode_samples(pos, d_enc), self.dtype,
                                       torch.sigmoid)
        return self._composite(restored, z_probs)

    def _dense_shade_stage(self, o_sh, d_sh, z_world, z_probs, mask):
        """Shade every slot of every ray (dead slots at z = 1, masked out
        before the composite). Returns (B, 3)."""
        B, S = mask.shape
        z_safe = torch.where(mask, z_world, torch.ones_like(z_world))
        pos = o_sh[:, None, :] + d_sh[:, None, :] * z_safe[..., None]
        d_enc = d_sh
        if self.use_ndc:
            d_enc = unit(d_sh)
        dirs_exp = d_enc[:, None, :].expand(pos.shape)
        sig = mlp_rows(self.nerf, self._encode_samples(pos.reshape(-1, 3),
                                                       dirs_exp.reshape(-1, 3)),
                       self.dtype, torch.sigmoid).reshape(B, S, 4) * mask[..., None]
        return self._composite(sig, z_probs)

    @torch.no_grad()
    def render_rays(self, pose, rotation, dirs, compaction=None):
        """One ray batch -> (rgb (B, 3) f32, counts (B,) int32). compaction
        None takes the renderer's own choice; True or False picks the
        compacted or the dense shading stage."""
        o_sh, d_sh, z_world, z_probs, mask = self._oracle_stage(pose, rotation, dirs)
        compaction = self.compaction if compaction is None else compaction
        shade = self._shade_stage if compaction else self._dense_shade_stage
        rgb = shade(o_sh, d_sh, z_world, z_probs, mask)
        return rgb, mask.sum(dim=1, dtype=torch.int32)

    @torch.no_grad()
    def render_frame(self, pose, rotation, directions):
        """Whole frame in ``batch_size`` chunks. directions: (n, 3) on the
        renderer's device. Returns (rgb (n, 3), counts (n,))."""
        pose = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
        rotation = torch.as_tensor(rotation, dtype=torch.float32, device=self.device)
        outs = [self.render_rays(pose, rotation, directions[s:s + self.batch_size])
                for s in range(0, directions.shape[0], self.batch_size)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
