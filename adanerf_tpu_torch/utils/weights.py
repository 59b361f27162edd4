"""Carry weights across from the JAX package.

Both functions fill a module of ``adanerf_tpu_torch.models.mlp`` from the
JAX layout, where parameters are ``(in, out)`` matrices under flat dotted
keys (``0.w``, ``pts.5.w``, ``views.0.b``, ...): ``from_jax_params`` takes
the JAX parameter pytree converted to numpy, ``load_export_weights`` reads
an exported ``model{0,1}.weights`` npz file.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def flatten_params(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {dotted-path: array}, the key scheme
    of the JAX checkpoints."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat = {}
    for k, v in items:
        flat.update(flatten_params(v, f"{prefix}.{k}" if prefix else str(k)))
    return flat


def load_flat(module: torch.nn.Module, flat: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Copy flat fp32 arrays into ``module`` (keys and shapes must match
    exactly) and return it."""
    own = module.state_dict()
    if set(own) != set(flat):
        raise KeyError(f"weight keys differ: missing {sorted(set(own) - set(flat))}, "
                       f"unexpected {sorted(set(flat) - set(own))}")
    state = {}
    for k, v in own.items():
        arr = np.asarray(flat[k], np.float32)
        if tuple(arr.shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {arr.shape} != {tuple(v.shape)}")
        state[k] = torch.from_numpy(arr.copy())
    module.load_state_dict(state)
    return module


def from_jax_params(model_def: torch.nn.Module, params_numpy) -> torch.nn.Module:
    """Fill ``model_def`` from a JAX parameter pytree given as numpy."""
    return load_flat(model_def, flatten_params(params_numpy))


def load_export_weights(model_def: torch.nn.Module, path: str) -> torch.nn.Module:
    """Fill ``model_def`` from an exported ``model{i}.weights`` npz."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return load_flat(model_def, flat)
