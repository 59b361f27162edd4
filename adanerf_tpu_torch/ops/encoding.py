"""Positional (frequency) encoding.

Counterpart of ``adanerf_tpu/ops/encoding.py``: the NeRF encoding
``[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{F-1} x), cos(2^{F-1} x)]`` where
each sin/cos block spans all C coordinates.
"""

from __future__ import annotations

from functools import partial

import torch


def positional_encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """x: (..., C) -> (..., C * (2*n_freqs + 1)); layout [x, sin f0, cos f0, ...]."""
    if n_freqs <= 0:
        return x
    # the powers of two made on x's device (exact), not copied from the host
    bands = torch.ldexp(torch.ones(n_freqs, device=x.device),
                        torch.arange(n_freqs, device=x.device))
    lead, C = x.shape[:-1], x.shape[-1]
    F = int(n_freqs)
    xf = (x[..., None, :] * bands[:, None]).reshape(*lead, F, 1, C)
    sc = torch.cat([torch.sin(xf), torch.cos(xf)], dim=-2).reshape(*lead, 2 * F * C)
    return torch.cat([x, sc], dim=-1)


def encoded_width(name: str, n: int, n_freqs: int) -> int:
    """Number of output features."""
    if name == "nerf":
        return n * 2 * n_freqs + n
    return n


def get_encoder(name: str, n_freqs: int):
    """'nerf' -> frequency encoder with n_freqs bands; 'none' -> identity."""
    if name == "nerf":
        return partial(positional_encode, n_freqs=n_freqs)
    if name == "none":
        return lambda x: x
    raise ValueError(f"Encoding {name} not implemented")
