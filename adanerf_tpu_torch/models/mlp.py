"""The two model families as ``nn.Module``s: a relu MLP with a textual
skip-connection DSL (``BaseNetDef``, the sampling oracle) and the NeRF
shading MLP with a view-direction branch (``NeRFDef``).

Counterpart of ``adanerf_tpu/models/mlp.py``. Weights are stored in
``(in, out)`` layout under the JAX package's flat keys, so a module's
``state_dict()`` reads and writes the exported ``model{0,1}.weights`` files
unchanged: ``{i}.w`` / ``{i}.b`` for BaseNet; ``pts.{i}.w``, ``views.0.w``,
``alpha.w``, ``feature.w``, ``rgb.w`` (and ``.b``) for NeRF.

``forward(x, dtype=None)`` runs in fp32; ``dtype=torch.bfloat16`` rounds
each layer's input and weight to bf16 and accumulates in fp32, as the JAX
``_dense`` does with ``preferred_element_type=float32``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch
from torch import nn


class Dense(nn.Module):
    """y = x @ w + b with w in (in, out) layout."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(n_in, n_out))
        self.b = nn.Parameter(torch.empty(n_out))

    def reset(self, generator: torch.Generator, kaiming: bool):
        """kaiming=True: kaiming-normal weights (fan_in, gain sqrt 2);
        else torch Linear's default uniform. Bias: Linear's default."""
        n_in = self.w.shape[0]
        bound = 1.0 / math.sqrt(n_in)
        with torch.no_grad():
            if kaiming:
                self.w.normal_(0.0, math.sqrt(2.0 / n_in), generator=generator)
            else:
                self.w.uniform_(-bound, bound, generator=generator)
            self.b.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        w = self.w
        if dtype is not None:
            # bf16 operands, fp32 accumulation: products of bf16 values are
            # exact in fp32, so rounding then multiplying in fp32 is exact
            x = x.to(dtype).float()
            w = w.to(dtype).float()
        return x @ w + self.b


def parse_skip_dsl(skip: str, n_in: int) -> Dict[int, Tuple[int, int]]:
    """Parse the BaseNet skip DSL: '-'-separated parts ``loc[:start][:end]``.

      "3"           -> layer 3 gets the full input (0, n_in)
      "3:17"        -> layer 3 gets the single input feature 17
      "3:5:40"      -> layer 3 gets input slice [5, 40)
      "0::63-7:63:" -> layer 0 gets [0,63), layer 7 gets [63, n_in)
    Layer 0 defaults to the full input if not mentioned.
    """
    locations: Dict[int, Tuple[int, int]] = {0: (0, n_in)}
    if skip:
        locations = {}
        for s in skip.split('-'):
            match = re.search(r'^([0-9]+)(:?)([0-9]*)(:?)([0-9]*)$', s)
            if not match:
                raise ValueError(f"could not decode skip info: {s!r}")
            loc = int(match.group(1))
            has_first, start_feat = match.group(2), match.group(3)
            has_between, end_feat = match.group(4), match.group(5)
            if has_first == '' and has_between == '':
                locations[loc] = (0, n_in)
            elif has_first == ':' and has_between == '':
                single = int(start_feat + end_feat)
                locations[loc] = (single, single + 1)
            else:
                istart = int(start_feat) if start_feat != '' else 0
                iend = int(end_feat) if end_feat != '' else n_in
                locations[loc] = (istart, iend)
        if 0 not in locations:
            locations[0] = (0, n_in)
    return locations


def auto_skip(skip: str, depth: int, pos_enc_args: str) -> str:
    """Resolve the 'auto' skip shorthand: feed the positional part again at
    layer depth*k//8 (k = 7 unless given as 'autoK')."""
    skip_layer = 7
    if len(skip) > 4:
        skip_layer = int(skip[4:])
    pos_inputs = int(pos_enc_args.split('-')[0]) * 6 + 3
    return f"0::{pos_inputs}-{depth * skip_layer // 8}:{pos_inputs}:"


class BaseNetDef(nn.Module):
    """Relu MLP with skip concats; no activation on the last layer."""

    def __init__(self, depth: int, width: int, n_in: int, n_out: int,
                 skip: str = "", net_idx: int = 0):
        super().__init__()
        self.depth, self.width = depth, width
        self.n_in, self.n_out = n_in, n_out
        self.skip, self.net_idx = skip, net_idx
        self.input_locations = parse_skip_dsl(skip, n_in)
        for i, (a, b) in enumerate(self.layer_dims()):
            self.add_module(str(i), Dense(a, b))

    def layer_dims(self) -> List[Tuple[int, int]]:
        locs = self.input_locations
        dims = [(locs[0][1] - locs[0][0], self.width)]
        for i in range(1, self.depth):
            extra = (locs[i][1] - locs[i][0]) if i in locs else 0
            n_out = self.width if i != self.depth - 1 else self.n_out
            dims.append((self.width + extra, n_out))
        return dims

    def layers(self) -> List[Dense]:
        return [getattr(self, str(i)) for i in range(self.depth)]

    def reset_parameters(self, generator: torch.Generator):
        for layer in self.layers():
            layer.reset(generator, kaiming=True)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        locs = self.input_locations
        out = x[..., locs[0][0]:locs[0][1]]
        for i, layer in enumerate(self.layers()):
            if i in locs and i != 0:
                out = torch.cat([out, x[..., locs[i][0]:locs[i][1]]], dim=-1)
            out = layer(out, dtype)
            if i + 1 < self.depth:
                out = torch.relu(out)
        return out

    def macs_per_input(self) -> int:
        return sum(a * b for a, b in self.layer_dims())


class NeRFDef(nn.Module):
    """NeRF shading MLP: relu trunk with the positional input re-concatenated
    (``[input_pts, h]``) after each layer in ``skips``; alpha from the trunk,
    rgb from one W/2 layer over ``[feature, input_views]``."""

    def __init__(self, depth: int = 8, width: int = 256, input_ch: int = 63,
                 input_ch_views: int = 27, n_out: int = 4,
                 skips: Tuple[int, ...] = (4,), net_idx: int = 1):
        super().__init__()
        self.depth, self.width = depth, width
        self.input_ch, self.input_ch_views = input_ch, input_ch_views
        self.n_out, self.skips, self.net_idx = n_out, tuple(skips), net_idx
        W = width
        dims = [(input_ch, W)] + [((W + input_ch) if i in self.skips else W, W)
                                  for i in range(depth - 1)]
        self.pts = nn.ModuleList([Dense(a, b) for a, b in dims])
        self.views = nn.ModuleList([Dense(input_ch_views + W, W // 2)])
        self.feature = Dense(W, W)
        self.alpha = Dense(W, 1)
        self.rgb = Dense(W // 2, 3)

    def reset_parameters(self, generator: torch.Generator):
        for layer in list(self.pts) + list(self.views):
            layer.reset(generator, kaiming=True)
        for layer in (self.feature, self.alpha, self.rgb):
            layer.reset(generator, kaiming=False)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        input_pts = x[..., :self.input_ch]
        input_views = x[..., self.input_ch:self.input_ch + self.input_ch_views]
        h = input_pts
        for i, layer in enumerate(self.pts):
            h = torch.relu(layer(h, dtype))
            if i in self.skips:
                h = torch.cat([input_pts, h], dim=-1)
        alpha = self.alpha(h, dtype)
        feature = self.feature(h, dtype)
        h = torch.cat([feature, input_views], dim=-1)
        for layer in self.views:
            h = torch.relu(layer(h, dtype))
        rgb = self.rgb(h, dtype)
        return torch.cat([rgb, alpha], dim=-1)

    def macs_per_input(self) -> int:
        W = self.width
        total = self.input_ch * W
        for i in range(self.depth - 1):
            total += ((W + self.input_ch) if i in self.skips else W) * W
        total += (self.input_ch_views + W) * (W // 2)
        return total + W * W + W + (W // 2) * 3
