"""Loss registry: the AdaNeRF oracle loss (epoch-blended L1 against the
shading network's alphas) plus the standard members.

Counterpart of ``adanerf_tpu/pipeline/losses.py``. Every loss is a callable
``loss(outputs, targets, inference_dicts, epoch) -> scalar tensor``; the
epoch is a host number.
"""

from __future__ import annotations

import torch

from .keys import FSK


def _mse(a, b):
    return torch.mean((a - b) ** 2)


def _l1(a, b):
    return torch.mean(torch.abs(a - b))


class MSELoss:
    def __init__(self, config=None, net_idx=-1):
        pass

    def __call__(self, outputs, targets, inference_dicts=None, epoch=None,
                 inference_dict=None):
        return _mse(outputs, targets)


class LimitedDepthMSELoss:
    """MSE ignoring target pixels at/above the ignore value: such targets
    are replaced by the (detached) prediction, zeroing their residual."""

    def __init__(self, config=None, net_idx=-1):
        self.ignore_value = config.multiDepthIgnoreValue[net_idx]

    def __call__(self, outputs, targets, inference_dicts=None, epoch=None,
                 inference_dict=None):
        sel = torch.where(targets < self.ignore_value, targets, outputs.detach())
        return _mse(outputs, sel)


class MultiDepthLimitedMSELoss:
    """Bipartite-matched multi-depth MSE: greedily assign each target depth
    to its nearest remaining prediction, then limited MSE."""

    def __init__(self, config=None, net_idx=-1):
        self.ignore_value = config.multiDepthIgnoreValue[net_idx]

    def __call__(self, outputs, targets, inference_dicts=None, epoch=None,
                 inference_dict=None):
        big = torch.finfo(outputs.dtype).max
        out_cpy = outputs.detach().clone()
        rows = torch.arange(out_cpy.shape[0], device=outputs.device)
        resort = torch.zeros(targets.shape, dtype=torch.long, device=outputs.device)
        for i in range(targets.shape[-1]):
            ids = torch.argmin(torch.abs(out_cpy - targets[:, i:i + 1]), dim=-1)
            out_cpy[rows, ids] = big
            resort[:, i] = ids
        shuffled = torch.take_along_dim(outputs, resort, dim=-1)
        sel = torch.where(targets != self.ignore_value, targets, shuffled.detach())
        return _mse(shuffled, sel)


class MSEPlusWeightAccum:
    """MSE + (sum of compositing weights should reach 1) regularizer."""
    requires_alpha_beta = True

    def __init__(self, config=None, net_idx=-1):
        self.loss_alpha = config.lossAlpha[net_idx]
        self.loss_beta = config.lossBeta[net_idx]
        self.asymmetric = True

    def __call__(self, outputs, targets, inference_dicts=None, epoch=None,
                 inference_dict=None):
        d = inference_dict if inference_dict is not None else inference_dicts
        if isinstance(d, list):
            d = d[-1]
        w_sum = torch.sum(d[FSK.nerf_weights_output], dim=1)
        if self.asymmetric:
            w_sum = torch.clamp(w_sum, max=1.0)
        loss_w = _mse(w_sum, torch.ones_like(w_sum))
        return self.loss_alpha * _mse(outputs, targets) + self.loss_beta * loss_w


class BCEWithLogitsLoss:
    def __init__(self, config=None, net_idx=-1):
        pass

    def __call__(self, outputs, targets, inference_dicts=None, epoch=None,
                 inference_dict=None):
        # numerically stable mean BCE with logits
        return torch.mean(torch.clamp(outputs, min=0) - outputs * targets
                          + torch.log1p(torch.exp(-torch.abs(outputs))))


class CrossEntropyLoss:
    """Mean NLL; with class weights, sum(w nll) / sum(w) over the batch.

    That ratio of sums is no mean of equal counts, so on a rank of the
    data-parallel step (``group`` set by ``parallel.mesh``) the denominator
    is summed over the group's rays, and the rank's term is scaled by the
    group's size: the group's mean of the ranks' terms, and of their
    gradients, is then the whole batch's."""

    def __init__(self, config=None, net_idx=-1, weights=None):
        self.weights = weights
        self.group = None

    def __call__(self, outputs, targets, inference_dicts=None, epoch=None,
                 inference_dict=None):
        logp = torch.log_softmax(outputs, dim=-1)
        targets = targets.to(torch.long).reshape(-1)
        nll = -torch.take_along_dim(logp, targets[:, None], dim=-1)[:, 0]
        if self.weights is not None:
            w = self.weights.to(outputs.device)[targets]
            if self.group is None:
                return torch.sum(nll * w) / torch.sum(w)
            import torch.distributed as dist
            w_sum = torch.sum(w).detach()
            dist.all_reduce(w_sum, group=self.group)
            return torch.sum(nll * w) * dist.get_world_size(self.group) / w_sum
        return torch.mean(nll)


class NeRFWeightMultiplicationLoss:
    """The AdaNeRF oracle loss: epoch-blended L1 of the oracle's outputs
    against ones / zeros / the shading net's weights or (premultiplied)
    alphas. ``factor = clip((epoch - start)/duration, 0, 1)``; One fades out
    as Zero/NerfW/NerfA fade in."""

    def __init__(self, config=None, net_idx=-1):
        self.net_idx = net_idx
        self.loss_components = list(config.lossComponents)
        self.blend_factors = list(config.lossComponentBlending)
        self.blending_start = config.lossBlendingStart
        self.blending_interval = config.lossBlendingDuration

    def blends(self, epoch):
        """Each component's blend weight, computed in float32 on the host as
        the JAX version computes it on the device."""
        e = torch.tensor(float(epoch), dtype=torch.float32)
        factor = torch.clamp((e - self.blending_start) / self.blending_interval, 0.0, 1.0)
        out = []
        for name, bf in zip(self.loss_components, self.blend_factors):
            if name == "One":
                blend = 1.0 - factor * (1.0 - bf) if bf > 0.0 else 1.0 - factor
            else:
                blend = factor * bf if bf > 0.0 else factor
            out.append(float(blend))
        return out

    def __call__(self, outputs, targets, inference_dicts=None, epoch=None,
                 inference_dict=None):
        dicts = inference_dicts if inference_dicts is not None else inference_dict
        nxt = dicts[self.net_idx + 1]
        targets = {"One": lambda: torch.ones_like(outputs),
                   "Zero": lambda: torch.zeros_like(outputs),
                   "NerfW": lambda: nxt[FSK.nerf_weights_output],
                   "NerfA": lambda: nxt[FSK.nerf_alpha_output]}
        total = torch.zeros((), dtype=outputs.dtype, device=outputs.device)
        for name, blend in zip(self.loss_components, self.blends(epoch)):
            if name in targets:
                total = total + blend * _l1(outputs, targets[name]())
        return total


def get_loss_by_name(name: str, config, net_idx: int):
    """Loss registry."""
    if name == "MSE":
        return MSELoss(config, net_idx)
    if name == "LimitedDepthMSE":
        return LimitedDepthMSELoss(config, net_idx)
    if name == "MultiDepthLimitedMSE":
        return MultiDepthLimitedMSELoss(config, net_idx)
    if name == "MSEPlusWeightAccum":
        return MSEPlusWeightAccum(config, net_idx)
    if name == "BCEWithLogitsLoss":
        return BCEWithLogitsLoss(config, net_idx)
    if name == "CrossEntropyLoss":
        return CrossEntropyLoss(config, net_idx)
    if name == "CrossEntropyLossWeighted":
        w = torch.ones(config.multiDepthFeatures[net_idx] + 1, dtype=torch.float32)
        w[-1] = 0.0
        return CrossEntropyLoss(config, net_idx, weights=w)
    if name == "NeRFWeightMultiplicationLoss":
        return NeRFWeightMultiplicationLoss(config, net_idx)
    if name.lower() == "none":
        return None
    raise ValueError(f"Loss {name} unknown")
