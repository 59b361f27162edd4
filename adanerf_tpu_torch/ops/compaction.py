"""Ragged-sample compaction: the live samples of a (rays, S) layout packed
to the front of a fixed-capacity buffer, and scattered back.

Counterpart of ``adanerf_tpu/ops/compaction.py`` (``compact_indices``,
``scatter_back``). Nothing on the port's train or render path calls it:
K1 compacts inside its kernel, and the plain renderer gathers the live
samples with a boolean index.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compact_indices(mask_flat: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source positions of the first ``capacity`` True entries of
    ``mask_flat``: (src_idx (capacity,) int32, entries past the live count
    pointing at 0; the live count n_act, a 0-d int32 tensor)."""
    n = mask_flat.shape[0]
    positions = torch.cumsum(mask_flat.to(torch.int32), dim=0) - 1
    n_act = positions[-1] + 1
    slot = torch.where(mask_flat, positions, torch.full_like(positions, capacity))
    keep = slot < capacity
    src_idx = torch.zeros(capacity, dtype=torch.int32, device=mask_flat.device)
    src_idx[slot[keep].long()] = torch.arange(n, dtype=torch.int32,
                                              device=mask_flat.device)[keep]
    return src_idx, n_act


def scatter_back(values: torch.Tensor, src_idx: torch.Tensor, n_act: torch.Tensor,
                 out_size: int) -> torch.Tensor:
    """Compacted per-sample values (capacity, C) back to a flat (out_size,
    C) buffer, zeros where no live sample lands: the inverse of
    ``compact_indices``."""
    capacity = values.shape[0]
    live = torch.arange(capacity, device=values.device) < n_act
    out = torch.zeros((out_size, values.shape[-1]), dtype=values.dtype, device=values.device)
    out[src_idx[live].long()] = values[live]
    return out
