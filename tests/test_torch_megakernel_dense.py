"""K2, the dense-slot frame renderer (ops/kernels/megakernel_dense.py).

On the CPU its wrapper runs the plain version (the renderer's dense path);
that is held against the JAX kernel it replaces, make_megakernel, in Pallas
interpret mode with f32 packed weights (tile 64, 128 rays of
trained_mscene_export, as tests/test_megakernel.py does): counts exact, rgb
within 2e-4, at the export's threshold, at thresholds overridden on both
sides, and at an odd slot count. The CUDA kernel itself is held against the
plain version and against K1 in tests/test_torch_kernels_cuda.py, which
runs only where there is a GPU, and by chip_smoke.py."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adanerf_tpu.ops.pallas.megakernel import (make_megakernel, pack_nerf_weights,
                                               pack_oracle_weights, prep_inputs)
from adanerf_tpu_torch import viewer as tviewer
from adanerf_tpu_torch.ops.kernels import build
from adanerf_tpu_torch.ops.kernels.megakernel_compact import MegakernelCompact
from adanerf_tpu_torch.ops.kernels.megakernel_dense import SOURCE, MegakernelDense

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import viewer as jviewer  # noqa: E402  (the JAX package's root viewer)

MSCENE = os.path.join(ROOT, "demo", "trained_mscene_export")
NDC = os.path.join(ROOT, "demo", "trained_ndc_export")


def _frame_inputs(scene, n):
    dirs = tviewer.frame_directions(scene, 16, n // 16, "cpu")
    pose = tviewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 8)[1]
    return dirs, np.asarray(pose, np.float32), np.eye(3, dtype=np.float32)


@pytest.mark.parametrize("threshold,samples", [(None, None), (0.01, None), (0.5, None),
                                               (0.9, None), (None, 3)])
def test_plain_matches_jax_kernel_interpret(threshold, samples):
    rt_j, scene_j = jviewer.build_renderer_from_export(MSCENE, 128, "fp32")
    rt_t, scene_t = tviewer.build_renderer_from_export(MSCENE, 128, "fp32", device="cpu")
    if threshold is not None:
        rt_j.config.adaptiveSamplingThreshold = threshold
        rt_t.threshold = threshold
    if samples is not None:
        rt_j.config.numRaymarchSamples = [rt_j.config.numRaymarchSamples[0], samples]
        rt_t.max_samples = samples
    dirs, pose, rot = _frame_inputs(scene_t, 128)

    po = pack_oracle_weights(rt_j.oracle_def, rt_j.params[0], dtype=jnp.float32)
    pn = pack_nerf_weights(rt_j.nerf_def, rt_j.params[1], dtype=jnp.float32)
    run = make_megakernel(rt_j.oracle_def, rt_j.nerf_def, scene_j, rt_j.config,
                          tile=64, interpret=True)(po, pn)
    out = np.asarray(run(*prep_inputs(jnp.asarray(dirs.numpy()), jnp.asarray(pose),
                                      jnp.asarray(rot))))

    mk = MegakernelDense(rt_t)
    before = (MegakernelDense.launches, MegakernelCompact.launches)
    rgb, counts = mk(dirs, pose, rot)
    # CPU tensors never reach either kernel
    assert (MegakernelDense.launches, MegakernelCompact.launches) == before
    np.testing.assert_array_equal(counts.numpy(), out[:, 3].astype(int))
    np.testing.assert_allclose(rgb.numpy(), out[:, :3], atol=2e-4, rtol=0)
    assert counts.max() <= rt_t.max_samples and counts.min() >= 1


def test_lower_threshold_keeps_more_slots():
    rt, scene = tviewer.build_renderer_from_export(MSCENE, 4096, "fp32", device="cpu")
    dirs, pose, rot = _frame_inputs(scene, 1024)
    mk = MegakernelDense(rt)
    _, at_export = mk(dirs, pose, rot)
    rt.threshold = 0.01
    _, at_low = mk(dirs, pose, rot)
    assert float(at_low.float().mean()) > float(at_export.float().mean())


def _fresh(path=MSCENE):
    return tviewer.build_renderer_from_export(path, 128, "fp32", device="cpu")[0]


def test_wrapper_refuses_what_the_kernel_does_not_implement():
    with pytest.raises(ValueError, match="NDC"):
        MegakernelDense(_fresh(NDC))
    rt = _fresh()
    rt.norm_name = "None"
    with pytest.raises(ValueError, match="InverseSqrtDistCentered"):
        MegakernelDense(rt)
    rt = _fresh()
    rt.accumulation_mult = "weights"
    with pytest.raises(ValueError, match="'alpha' only"):
        MegakernelDense(rt)
    rt = _fresh()
    rt.z_no_range = True
    with pytest.raises(ValueError, match="NoDepthRange"):
        MegakernelDense(rt)
    rt = _fresh()  # and K1's own limits
    rt.threshold = 0.0
    with pytest.raises(ValueError, match="adaptive model"):
        MegakernelDense(rt)
    with pytest.raises(ValueError, match="unsupported device"):
        MegakernelDense(_fresh())(torch.zeros((4, 3), device="meta"), np.zeros(3), np.eye(3))


def test_front_runs_only_on_the_card():
    """front (the kernel's first stage alone, read by chip_smoke.py's float64
    witness) has no plain version: on a CPU tensor it raises and launches
    nothing."""
    mk = MegakernelDense(_fresh())
    before = MegakernelDense.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        mk.front(torch.zeros((4, 3)), np.zeros(3), np.eye(3))
    assert MegakernelDense.launches == before


def test_source_builds_with_the_shared_header():
    assert SOURCE == "megakernel_dense.cu"
    with open(os.path.join(build.CSRC_DIR, SOURCE)) as f:
        text = f.read()
    assert '#include "megakernel.cuh"' in text and "launch_all<float, true>" in text
    cmd = build.nvcc_command("nvcc", SOURCE, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1].endswith(SOURCE)
