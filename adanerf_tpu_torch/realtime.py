"""Adaptive renderer, plain PyTorch path.

Counterpart of ``adanerf_tpu/realtime.py::RealtimeRenderer``. Per ray batch:

  1. ``_oracle_stage``: rotate the camera-space dirs into the world, take the
     view-cell sphere exit point, encode ``[dir | pos]`` and run the oracle
     MLP; adaptive select on the raw logits gives each ray's depth slots,
     their oracle values and a validity mask. NDC exports move the shading
     rays into NDC space here (the oracle features stay world-space).
  2. ``_shade_stage``: gather only the live (ray, slot) samples, normalize
     and encode them, run the NeRF MLP on that compact batch and scatter the
     raw rgba back by (ray, slot).
  3. ``_composite``: front-to-back alpha compositing with the oracle value
     premultiplied into alpha.

This is the plain version that the hand-written CUDA kernel
(``ops/kernels/megakernel_compact.py``) is held against; the TPU-specific
workarounds of the JAX stage (segmented scans, one-hot selects, capacity
buckets) become native ``nonzero`` / index ops.
"""

from __future__ import annotations

import torch

from .ops.encoding import get_encoder
from .ops.normalization import get_normalization
from .ops.raymarch import ndc_rays, ray_sphere_offset
from .ops.samplers import adaptive_select, linearly_spaced_z


class RealtimeRenderer:
    """Compacted adaptive renderer for the AdaNeRF oracle + NeRF cascade.

    oracle, nerf: ``BaseNetDef`` / ``NeRFDef`` modules on ``device``.
    dtype: None for fp32 MLPs, ``torch.bfloat16`` for bf16 operands with
    fp32 accumulation (the production precision of the kernel).
    """

    def __init__(self, oracle, nerf, scene, config, batch_size: int = 65536,
                 dtype=None, device="cuda"):
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

    def _oracle_stage(self, pose, rotation, dirs):
        """dirs: (B, 3) camera-space unit dirs; pose (3,); rotation (3, 3).
        Returns (o_sh, d_sh, z_world, z_probs, mask): shading-ray origins and
        directions (B, 3), and (B, S) slot depths (0 at dead slots), oracle
        values and validity."""
        sc = self.scene
        nds = dirs @ rotation.T
        origins = pose.expand(nds.shape)
        distance = ray_sphere_offset(nds, origins, self.center, sc.view_cell_radius)
        proj = origins + nds * distance[:, None]

        x = torch.cat([self.enc0_dir(nds), self.enc0_pos(proj)], dim=-1)
        oracle_out = self.oracle(x, self.dtype).float()

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
            d_enc = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        raw = self.nerf(self._encode_samples(pos, d_enc), self.dtype).float()
        restored = torch.zeros((B, S, 4), dtype=torch.float32, device=mask.device)
        restored[ray, slot] = torch.sigmoid(raw)
        return self._composite(restored, z_probs)

    @torch.no_grad()
    def render_rays(self, pose, rotation, dirs):
        """One ray batch -> (rgb (B, 3) f32, counts (B,) int32)."""
        o_sh, d_sh, z_world, z_probs, mask = self._oracle_stage(pose, rotation, dirs)
        rgb = self._shade_stage(o_sh, d_sh, z_world, z_probs, mask)
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
