"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where torch sees no GPU. The file imports no
JAX (the GPU machine has none), so it runs there without the suite's
conftest:

  python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from adanerf_tpu_torch import viewer as tviewer
from adanerf_tpu_torch.ops.kernels.megakernel_compact import MegakernelCompact

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORTS = {"mscene": os.path.join(ROOT, "demo", "trained_mscene_export"),
           "ndc": os.path.join(ROOT, "demo", "trained_ndc_export")}


def _frame_inputs(scene, n):
    dirs = tviewer.frame_directions(scene, 128, n // 128, "cpu")
    pose = tviewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 8)[1]
    return dirs, np.asarray(pose, np.float32), np.eye(3, dtype=np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("mscene", "fp32"), ("ndc", "fp32"), ("mscene", "bf16")])
def test_cuda_kernel_matches_plain(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_kernels_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    rt, scene = tviewer.build_renderer_from_export(EXPORTS[name], dtype_str=dtype, device="cuda")
    dirs, pose, rot = _frame_inputs(scene, 16384)
    mk = MegakernelCompact(rt)
    before = MegakernelCompact.launches
    rgb_k, cnt_k = mk(dirs.cuda(), pose, rot)
    assert MegakernelCompact.launches == before + 1
    rgb_p, cnt_p = mk.plain(dirs.cuda(), torch.from_numpy(pose).cuda(), torch.from_numpy(rot).cuda())
    agree = cnt_k == cnt_p
    # fp32: a logit within rounding of the threshold may flip one bin (the
    # two sides sum in different orders): <= 1 ray in 10,000, rgb 2e-4 on
    # the rest; bf16: a flip of a bf16 rounding boundary moves more, so the
    # frame is held to the same 40 dB as chip_smoke.py
    if dtype == "fp32":
        assert int((~agree).sum()) <= dirs.shape[0] // 10000
        assert float((rgb_k - rgb_p).abs()[agree].max()) <= 2e-4
    else:
        mse = float(((rgb_k.clamp(0, 1) - rgb_p.clamp(0, 1)) ** 2).mean())
        assert mse == 0 or -10 * np.log10(mse) >= 40.0
