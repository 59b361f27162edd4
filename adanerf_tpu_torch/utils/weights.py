"""Carry weights and optimizer state across to and from the JAX package.

In the JAX layout parameters are ``(in, out)`` matrices under flat dotted
keys (``0.w``, ``pts.5.w``, ``views.0.b``, ...), which the port's modules
use as their ``state_dict`` keys. ``from_jax_params`` fills a module from
the JAX parameter pytree converted to numpy, ``load_export_weights`` from
an exported ``model{0,1}.weights`` npz file, and ``to_flat`` goes the other
way. Adam's state (``optax.scale_by_adam``) flattens to ``.count``,
``.mu.<key>`` and ``.nu.<key>``, the names the JAX checkpoints use
(``adam_to_flat`` / ``adam_from_flat``).
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


def to_flat(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """A module's parameters as {dotted-key: fp32 numpy array}."""
    return {k: v.detach().to("cpu", torch.float32).numpy() for k, v in module.state_dict().items()}


def adam_to_flat(state) -> Dict[str, np.ndarray]:
    """An ``AdamState`` as the JAX checkpoint's flat dict: ``.count``
    (int32), ``.mu.<key>``, ``.nu.<key>`` (fp32)."""
    flat = {".count": np.asarray(int(state.count), np.int32)}
    for k, v in state.mu.items():
        flat[f".mu.{k}"] = v.detach().to("cpu", torch.float32).numpy()
    for k, v in state.nu.items():
        flat[f".nu.{k}"] = v.detach().to("cpu", torch.float32).numpy()
    return flat


def adam_from_flat(state, flat: Dict[str, np.ndarray]):
    """Fill an ``AdamState`` in place from the JAX checkpoint's flat dict
    (keys and shapes must match exactly)."""
    want = {".count"} | {f".mu.{k}" for k in state.mu} | {f".nu.{k}" for k in state.nu}
    if set(flat) != want:
        raise KeyError(f"optimizer keys differ: missing {sorted(want - set(flat))}, "
                       f"unexpected {sorted(set(flat) - want)}")
    for prefix, moments in ((".mu.", state.mu), (".nu.", state.nu)):
        for k, v in moments.items():
            arr = np.asarray(flat[prefix + k], np.float32)
            if tuple(arr.shape) != tuple(v.shape):
                raise ValueError(f"{prefix + k}: shape {arr.shape} != {tuple(v.shape)}")
            v.copy_(torch.from_numpy(arr.copy()))
    state.count = int(np.asarray(flat[".count"]))
    return state
