"""A seeded export of the port's MLPs at another width, for the tests of the
frame kernels (K1, K2) and the viewer. Imports no JAX: the card's tests
use it too."""

import os

import numpy as np
import torch

from adanerf_tpu_torch.models.mlp import BaseNetDef, NeRFDef
from adanerf_tpu_torch.utils.weights import to_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_wide_export(dst, width, seed, depth=(4, 4), config_edit=None, logit_scale=0.1,
                      nerf_pos=10):
    """demo/trained_mscene_export with both MLPs replaced by seeded ones of
    ``width`` (one width for both, or (oracle, NeRF)) and ``depth`` layers
    (the NeRF's skip at its last layer but one), written where both viewers
    read them (model0.weights, model1.weights); ``nerf_pos``: the NeRF's
    position encoding frequencies (posEncArgs[1], 6 nerf_pos + 3 input
    columns); ``config_edit(text)`` may rewrite config.ini. The oracle's
    last layer is scaled by ``logit_scale``, so that its logits lie around
    the export's threshold, as a trained oracle's do (freshly initialised,
    every bin would pass it). Returns the export directory."""
    w0, w1 = (width, width) if isinstance(width, int) else width
    src = os.path.join(ROOT, "demo", "trained_mscene_export")
    os.makedirs(dst, exist_ok=True)
    for name in ("config.ini", "dataset_info.txt", "pos_enc.txt"):
        with open(os.path.join(src, name)) as f:
            text = f.read()
        if name == "config.ini":
            text = text.replace("posEncArgs = [10-4, 10-4]", f"posEncArgs = [10-4, {nerf_pos}-4]")
            if config_edit is not None:
                text = config_edit(text)
        with open(os.path.join(dst, name), "w") as f:
            f.write(text)
    g = torch.Generator().manual_seed(seed)
    oracle = BaseNetDef(depth[0], w0, 90, 128, "")
    nerf = NeRFDef(depth[1], w1, 6 * nerf_pos + 3, 27, 4, (depth[1] - 3,))
    for i, m in enumerate((oracle, nerf)):
        m.reset_parameters(g)
        flat = to_flat(m)
        if i == 0:
            flat[f"{depth[0] - 1}.w"] *= logit_scale
        with open(os.path.join(dst, f"model{i}.weights"), "wb") as f:
            np.savez(f, **flat)
    return str(dst)
