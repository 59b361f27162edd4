"""Reference-checkpoint ingestion: the reference's torch
``{name}_{suffix}.weights`` files (``torch.save`` of an ``nn.Module``
state dict) become the port's flat checkpoints, so a scene trained with the
reference renders and resumes in the port.

Counterpart of ``adanerf_tpu/utils/torch_ckpt.py``; here ``torch.load`` is
native. A checkpoint is a pickle, so convert only files you trust.

State-dict layouts handled:
  * BaseNet:  ``layers.{i}.weight/bias``
  * NeRF:     ``pts_linears.{i}.*``, ``views_linears.0.*``,
    ``feature_linear.*``, ``alpha_linear.*``, ``rgb_linear.*``
    (or ``output_linear.*`` without view directions)

torch Linear stores a weight as (out, in) and the port as (in, out), so
every weight transposes; biases map 1:1. The same names key the ONNX
initializers (``utils/onnx_weights.py``), so both readers share the maps.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..train_state import save_tree


def _to_numpy_state_dict(path: str) -> Dict[str, np.ndarray]:
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(obj, dict):
        # the reference sometimes saves the whole module
        obj = obj.state_dict()
    return {k: v.detach().cpu().numpy().astype(np.float32) for k, v in obj.items()}


def load_tensor_dict(path: str, keys) -> Dict[str, np.ndarray]:
    """``keys`` of a ``torch.save``d dict of tensors (the reference's
    ``*_QuantizedWeights_*.raw`` dumps), or of an npz with the same keys,
    as numpy arrays."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:  # not a torch container: the npz form
        with np.load(path, allow_pickle=True) as npz:
            return {k: np.asarray(npz[k]) for k in keys}
    return {k: obj[k].detach().cpu().numpy() if isinstance(obj[k], torch.Tensor)
            else np.asarray(obj[k]) for k in keys}


def basenet_flat_from_torch(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """BaseNet state dict -> flat keys ``{i}.w`` / ``{i}.b``."""
    flat = {}
    n_layers = max(int(k.split(".")[1]) for k in sd if k.startswith("layers.")) + 1
    for i in range(n_layers):
        flat[f"{i}.w"] = sd[f"layers.{i}.weight"].T.copy()
        flat[f"{i}.b"] = sd[f"layers.{i}.bias"].copy()
    return flat


def nerf_flat_from_torch(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """NeRF state dict -> the flat keys of ``NeRFDef``'s state dict."""
    flat = {}
    n_pts = max(int(k.split(".")[1]) for k in sd if k.startswith("pts_linears.")) + 1
    for i in range(n_pts):
        flat[f"pts.{i}.w"] = sd[f"pts_linears.{i}.weight"].T.copy()
        flat[f"pts.{i}.b"] = sd[f"pts_linears.{i}.bias"].copy()
    n_views = max((int(k.split(".")[1]) for k in sd
                   if k.startswith("views_linears.")), default=-1) + 1
    for i in range(n_views):
        flat[f"views.{i}.w"] = sd[f"views_linears.{i}.weight"].T.copy()
        flat[f"views.{i}.b"] = sd[f"views_linears.{i}.bias"].copy()
    for ref_name, my_name in (("feature_linear", "feature"),
                              ("alpha_linear", "alpha"),
                              ("rgb_linear", "rgb"),
                              ("output_linear", "output")):
        if f"{ref_name}.weight" in sd:
            flat[f"{my_name}.w"] = sd[f"{ref_name}.weight"].T.copy()
            flat[f"{my_name}.b"] = sd[f"{ref_name}.bias"].copy()
    return flat


def flat_from_state_dict(sd: Dict[str, np.ndarray], source: str) -> Dict[str, np.ndarray]:
    """Either family's state dict -> flat keys, the family detected from
    the names; ``source`` names the input in the error."""
    if any(k.startswith("layers.") for k in sd):
        return basenet_flat_from_torch(sd)
    if any(k.startswith("pts_linears.") for k in sd):
        return nerf_flat_from_torch(sd)
    raise ValueError(f"unrecognized state dict in {source}: {sorted(sd)[:5]}...")


def convert_torch_checkpoint(src: str, dst: str = None) -> str:
    """Convert one reference ``.weights`` file to the port's npz format,
    keeping its file name (``{name}_{suffix}.weights``) so
    ``TrainState.load_latest_weights`` finds it. Default: in place."""
    flat = flat_from_state_dict(_to_numpy_state_dict(src), src)
    dst = dst or src
    save_tree(dst, flat)
    return dst


def convert_experiment_dir(src_dir: str, dst_dir: str, suffix: str = None):
    """Convert every model checkpoint of a reference experiment directory
    (all but ``_opt`` ones; with ``suffix``, only those ending in it)."""
    os.makedirs(dst_dir, exist_ok=True)
    done = []
    for f in sorted(os.listdir(src_dir)):
        if not f.endswith(".weights") or "_opt.weights" in f:
            continue
        if suffix is not None and not f.endswith(f"_{suffix}.weights"):
            continue
        done.append(convert_torch_checkpoint(os.path.join(src_dir, f),
                                             os.path.join(dst_dir, f)))
    if not done:
        detail = f" with suffix '{suffix}'" if suffix is not None else ""
        raise FileNotFoundError(f"no model .weights files{detail} in {src_dir}")
    return done
