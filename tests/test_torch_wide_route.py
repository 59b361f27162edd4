"""The widths that run on the wide path (csrc/wide.cu, ops/kernels/wide.py)
because it measured faster there than the fused libraries: 384 and 512
columns, for K1/K2's MLPs and K3's NeRF (PERF.md §6). Each width's
wide launch sequence, replayed on the CPU (tests/torch_wide_replay.py),
against the JAX kernel it replaces in interpret mode, and the route each
wrapper takes at every width the fused kernels held before."""

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
from adanerf_tpu_torch.models.mlp import NeRFDef
from adanerf_tpu_torch.ops.kernels import megakernel_compact as mc
from adanerf_tpu_torch.ops.kernels import nerf_train as nt
from adanerf_tpu_torch.ops.kernels.megakernel_compact import MegakernelCompact
from adanerf_tpu_torch.ops.kernels.megakernel_dense import MegakernelDense
from adanerf_tpu_torch.ops.kernels.nerf_train import NerfTrainKernel
from test_torch_train_kernel import _check_flips, _jax_kernel_grads, _setup
from torch_wide_export import write_wide_export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import viewer as jviewer  # noqa: E402  (the JAX package's root viewer)

MOVED = (384, 512)  # the widths that left the fused libraries


@pytest.mark.parametrize("width", [128, 256, 384, 512, 640])
def test_route_is_the_shape_alone(width):
    """K1/K2's halves and K3 take the fused kernels at 128 and 256 columns
    and the wide path at every other width: the route reads the network's
    shape and nothing else. Builds the wrappers only."""
    nerf = NeRFDef(4, width, 63, 27, 4, (2,))
    assert NerfTrainKernel(nerf).wide == (width > 256)
    assert nt.libraries(width, 90, 4) == ([nt.library(width)] if width <= 256
                                          else ["wide.cu", nt.library(256)])
    assert (width in mc.WIDTHS) == (width <= 256)


@pytest.mark.parametrize("width", MOVED)
def test_k3_wide_path_matches_jax_kernel_at_moved_widths(width):
    """K3 at 384 and 512 columns as the card runs it now: the stream replay
    and the wide path's own launch sequence replayed on the CPU (the
    forward's GEMMs and heads, the recompute into the scratch, the heads'
    gradients, the chain's cotangents with their relu masks and bias
    partials, dX, then the weight-gradient table) against the JAX kernel
    in interpret mode at _check_flips' bars, as
    test_torch_train_kernel.py::test_wide_path_matches_jax_kernel holds
    the widths above 512."""
    from torch_wide_replay import k3_backward_on_cpu, k3_forward_on_cpu
    depth, skips = 3, (1,)
    jdef, params, tdef, x, g = _setup(depth, width, skips, 200, width + depth)
    out_ref, grads_ref = _jax_kernel_grads(jdef, params, x, g)
    k3 = NerfTrainKernel(tdef)
    assert k3.wide and k3.xw == 128
    with torch.no_grad():
        xt, gt = torch.from_numpy(x), torch.from_numpy(g)
        out = k3_forward_on_cpu(k3, xt)
        dx, grads = k3_backward_on_cpu(k3, xt, gt)
    grads = {k: v.numpy() for k, v in grads.items()}
    grads["x"] = dx.numpy()
    assert sorted(grads) == sorted(grads_ref)
    _check_flips(out.numpy(), grads, out_ref, grads_ref, width, depth)


def _frame_inputs(scene, n):
    dirs = tviewer.frame_directions(scene, 16, n // 16, "cpu")
    pose = tviewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 8)[1]
    return dirs, np.asarray(pose, np.float32), np.eye(3, dtype=np.float32)


@pytest.mark.parametrize("width,dtype,dense", [(384, "fp32", False), (384, "bf16", False),
                                               (384, "bf16", True), (512, "fp32", False),
                                               (512, "bf16", False), (512, "fp32", True)])
def test_frame_wide_path_matches_at_moved_widths(tmp_path, monkeypatch, width, dtype, dense):
    """K1 (and K2) with both MLPs 384 or 512 wide, as the card runs them now:
    the wide path's launch sequence for the front and the shade, each
    kernel replayed on the CPU in chunks of 256 sample rows, against the
    plain version (counts exact; rgb within 2e-4 in fp32, within 2e-3 in
    bf16, where a sum the two sides order differently may round to the
    other bf16 value), and in fp32 against make_megakernel_compact in
    interpret mode (counts exact, rgb within 2e-4), as
    tests/test_torch_megakernel_compact.py holds the widths above 512."""
    from torch_wide_replay import k1_wide_on_cpu
    monkeypatch.setattr(mc, "CHUNK", 256)
    export = write_wide_export(tmp_path / "export", width, 4 * width + 6, depth=(3, 3))
    rt, scene = tviewer.build_renderer_from_export(export, 128, dtype, device="cpu")
    dirs, pose, rot = _frame_inputs(scene, 128)
    mk = (MegakernelDense if dense else MegakernelCompact)(rt)
    assert mk.front_wide and mk.shade_wide
    rgb, counts = k1_wide_on_cpu(mk, dirs, pose, rot)
    rgb_p, counts_p = mk.plain(dirs, torch.from_numpy(pose), torch.from_numpy(rot))
    assert float(counts.float().mean()) >= 1.0
    np.testing.assert_array_equal(counts.numpy(), counts_p.numpy())
    np.testing.assert_allclose(rgb.numpy(), rgb_p.numpy(), atol=2e-4 if dtype == "fp32" else 2e-3,
                               rtol=0)
    if dtype != "fp32" or dense:
        return
    rt_j, scene_j = jviewer.build_renderer_from_export(export, 128, "fp32")
    po = pack_oracle_weights(rt_j.oracle_def, rt_j.params[0], dtype=jnp.float32)
    pn = pack_nerf_weights(rt_j.nerf_def, rt_j.params[1], dtype=jnp.float32)
    run = make_megakernel_compact(rt_j.oracle_def, rt_j.nerf_def, scene_j, rt_j.config,
                                  tile=64, chunk=64, interpret=True, dynamic=True)(po, pn)
    out = np.asarray(run(*prep_inputs(jnp.asarray(dirs.numpy()), jnp.asarray(pose),
                                      jnp.asarray(rot))))
    np.testing.assert_array_equal(counts.numpy(), out[:, 3].astype(int))
    np.testing.assert_allclose(rgb.numpy(), out[:, :3], atol=2e-4, rtol=0)
