"""K1, the compacted frame renderer (ops/kernels/megakernel_compact.py).

On the CPU its wrapper runs the plain version; that is held against the
JAX kernel it replaces, make_megakernel_compact, in Pallas interpret mode
with f32 packed weights (tile 64, 128 rays, as tests/test_megakernel3.py
does): counts exact, rgb within 2e-4. The CUDA kernel itself is held
against the plain version in tests/test_torch_kernels_cuda.py, which runs
only where there is a GPU, and by chip_smoke.py."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adanerf_tpu.ops.pallas.megakernel import (pack_nerf_weights, pack_oracle_weights,
                                               prep_inputs)
from adanerf_tpu.ops.pallas.megakernel3 import make_megakernel_compact
from adanerf_tpu_torch import viewer as tviewer
from adanerf_tpu_torch.ops.kernels import build
from adanerf_tpu_torch.ops.kernels.megakernel_compact import MegakernelCompact

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import viewer as jviewer  # noqa: E402  (the JAX package's root viewer)

EXPORTS = {"mscene": os.path.join(ROOT, "demo", "trained_mscene_export"),
           "ndc": os.path.join(ROOT, "demo", "trained_ndc_export")}


def _frame_inputs(scene, n):
    dirs = tviewer.frame_directions(scene, 16, n // 16, "cpu")
    pose = tviewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 8)[1]
    return dirs, np.asarray(pose, np.float32), np.eye(3, dtype=np.float32)


@pytest.mark.parametrize("name", ["mscene", "ndc"])
def test_plain_matches_jax_kernel_interpret(name):
    rt_j, scene_j = jviewer.build_renderer_from_export(EXPORTS[name], 128, "fp32")
    rt_t, scene_t = tviewer.build_renderer_from_export(EXPORTS[name], 128, "fp32", device="cpu")
    dirs, pose, rot = _frame_inputs(scene_t, 128)

    po = pack_oracle_weights(rt_j.oracle_def, rt_j.params[0], dtype=jnp.float32)
    pn = pack_nerf_weights(rt_j.nerf_def, rt_j.params[1], dtype=jnp.float32)
    run = make_megakernel_compact(rt_j.oracle_def, rt_j.nerf_def, scene_j, rt_j.config,
                                  tile=64, chunk=64, interpret=True, dynamic=True)(po, pn)
    out = np.asarray(run(*prep_inputs(jnp.asarray(dirs.numpy()), jnp.asarray(pose),
                                      jnp.asarray(rot))))

    mk = MegakernelCompact(rt_t)
    before = MegakernelCompact.launches
    rgb, counts = mk(dirs, pose, rot)
    assert MegakernelCompact.launches == before  # CPU tensors never reach the kernel
    np.testing.assert_array_equal(counts.numpy(), out[:, 3].astype(int))
    np.testing.assert_allclose(rgb.numpy(), out[:, :3], atol=2e-4, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_implement():
    rt, _ = tviewer.build_renderer_from_export(EXPORTS["mscene"], 128, "fp32", device="cpu")
    rt.norm_name = "MaxDepth"
    with pytest.raises(ValueError, match="rayMarchNormalization"):
        MegakernelCompact(rt)
    rt, _ = tviewer.build_renderer_from_export(EXPORTS["mscene"], 128, "fp32", device="cpu")
    rt.threshold = 0.0
    with pytest.raises(ValueError, match="adaptive model"):
        MegakernelCompact(rt)
    rt, _ = tviewer.build_renderer_from_export(EXPORTS["mscene"], 128, "fp32", device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        MegakernelCompact(rt)(torch.zeros((4, 3), device="meta"), np.zeros(3), np.eye(3))


def test_build_flags_and_missing_nvcc(monkeypatch, tmp_path):
    assert "-use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    cmd = build.nvcc_command("nvcc", "megakernel_compact.cu", "out.so")
    assert cmd[0] == "nvcc" and cmd[-1].endswith(os.path.join("csrc", "megakernel_compact.cu"))
    path = build.library_path("megakernel_compact.cu")
    assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.find_nvcc()
