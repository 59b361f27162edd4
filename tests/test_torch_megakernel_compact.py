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
from torch_wide_export import write_wide_export

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


@pytest.mark.parametrize("width", [128, 384])
def test_plain_matches_jax_kernel_interpret_at_other_widths(tmp_path, width):
    """The same comparison on a seeded export at another MLP width (a
    64-wide views layer at 128, on the fused kernels; 384 on the card's
    wide path), which K1 takes at every width."""
    export = write_wide_export(tmp_path / "export", width, width)
    rt_j, scene_j = jviewer.build_renderer_from_export(export, 128, "fp32")
    rt_t, scene_t = tviewer.build_renderer_from_export(export, 128, "fp32", device="cpu")
    assert rt_t.nerf.width == rt_j.nerf_def.width == width
    dirs, pose, rot = _frame_inputs(scene_t, 128)
    po = pack_oracle_weights(rt_j.oracle_def, rt_j.params[0], dtype=jnp.float32)
    pn = pack_nerf_weights(rt_j.nerf_def, rt_j.params[1], dtype=jnp.float32)
    run = make_megakernel_compact(rt_j.oracle_def, rt_j.nerf_def, scene_j, rt_j.config,
                                  tile=64, chunk=64, interpret=True, dynamic=True)(po, pn)
    out = np.asarray(run(*prep_inputs(jnp.asarray(dirs.numpy()), jnp.asarray(pose),
                                      jnp.asarray(rot))))
    mk = MegakernelCompact(rt_t)
    assert mk.widths == (width, width)
    rgb, counts = mk(dirs, pose, rot)
    assert 1.0 <= float(counts.float().mean()) <= 8.0
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


# (oracle width, NeRF width) or one width for both, (oracle, NeRF) depths:
# mixed widths (the fused front and shade of two libraries, or a fused
# front and a wide shade), MLPs wider than 512 and widths that are not a
# multiple of 128 (the wide path, padded to 64-column blocks), 20 layers
NEW_SHAPES = {"128/256": ((128, 256), (4, 4)), "512/256": ((512, 256), (4, 4)),
              "256/640": ((256, 640), (3, 3)), "640": (640, (3, 3)), "1024": (1024, (2, 3)),
              "96/200": ((96, 200), (3, 3)), "oracle 20 layers": (256, (20, 4)),
              "NeRF 20 layers": (256, (4, 20))}


def _new_export(tmp_path, name, dtype="fp32"):
    width, depth = NEW_SHAPES[name]
    w0, w1 = (width, width) if isinstance(width, int) else width
    export = write_wide_export(tmp_path / "export", width, w0 + 3 * w1 + sum(depth), depth=depth)
    rt, scene = tviewer.build_renderer_from_export(export, 128, dtype, device="cpu")
    assert (rt.oracle.width, rt.nerf.width, rt.oracle.depth, rt.nerf.depth) == (w0, w1) + depth
    return export, rt, scene


@pytest.mark.parametrize("name", list(NEW_SHAPES))
def test_plain_matches_jax_kernel_interpret_at_new_shapes(tmp_path, name):
    """K1's plain version against make_megakernel_compact at the shapes it
    takes now: an oracle and a NeRF of different widths, MLPs 640 and 1024
    wide, a 20-layer oracle and a 20-layer NeRF (counts exact, rgb within
    2e-4), and widths that are not a multiple of 128 (96/200); the
    wrapper takes each, on the route it names."""
    export, rt_t, scene_t = _new_export(tmp_path, name)
    rt_j, scene_j = jviewer.build_renderer_from_export(export, 128, "fp32")
    assert (rt_j.oracle_def.width, rt_j.nerf_def.width) == (rt_t.oracle.width, rt_t.nerf.width)
    dirs, pose, rot = _frame_inputs(scene_t, 128)
    po = pack_oracle_weights(rt_j.oracle_def, rt_j.params[0], dtype=jnp.float32)
    pn = pack_nerf_weights(rt_j.nerf_def, rt_j.params[1], dtype=jnp.float32)
    run = make_megakernel_compact(rt_j.oracle_def, rt_j.nerf_def, scene_j, rt_j.config,
                                  tile=64, chunk=64, interpret=True, dynamic=True)(po, pn)
    out = np.asarray(run(*prep_inputs(jnp.asarray(dirs.numpy()), jnp.asarray(pose),
                                      jnp.asarray(rot))))
    mk = MegakernelCompact(rt_t)
    assert mk.widths == (rt_t.oracle.width, rt_t.nerf.width)
    assert (mk.front_wide, mk.shade_wide) == tuple(w not in (128, 256)
                                                   for w in mk.widths)
    rgb, counts = mk(dirs, pose, rot)
    assert float(counts.float().mean()) >= 1.0
    np.testing.assert_array_equal(counts.numpy(), out[:, 3].astype(int))
    np.testing.assert_allclose(rgb.numpy(), out[:, :3], atol=2e-4, rtol=0)


@pytest.mark.parametrize("name,dtype,dense", [("640", "fp32", False), ("640", "bf16", False),
                                              ("256/640", "bf16", False), ("1024", "bf16", False),
                                              ("96/200", "fp32", False), ("96/200", "bf16", True),
                                              ("oracle 20 layers", "fp32", False),
                                              ("640", "bf16", True)])
def test_wide_path_matches_plain_version(tmp_path, monkeypatch, name, dtype, dense):
    """The wide path's launch sequence for the front and the shade (K1's
    live rows, or K2's every slot), each kernel replayed on the CPU
    (tests/torch_wide_replay.py), in chunks of 256 sample rows, against the
    plain version: counts exact; rgb within 2e-4 in fp32 (float64 sums
    against fp32 ones), within 2e-3 in bf16, where a sum that the two sides
    order differently may round to the other bf16 value."""
    from adanerf_tpu_torch.ops.kernels import megakernel_compact as mc
    from adanerf_tpu_torch.ops.kernels.megakernel_dense import MegakernelDense
    from torch_wide_replay import k1_wide_on_cpu
    monkeypatch.setattr(mc, "CHUNK", 256)
    _, rt, scene = _new_export(tmp_path, name, dtype)
    dirs, pose, rot = _frame_inputs(scene, 128)
    mk = (MegakernelDense if dense else MegakernelCompact)(rt)
    rgb, counts = k1_wide_on_cpu(mk, dirs, pose, rot)
    rgb_p, counts_p = mk.plain(dirs, torch.from_numpy(pose), torch.from_numpy(rot))
    assert float(counts.float().mean()) >= 1.0
    np.testing.assert_array_equal(counts.numpy(), counts_p.numpy())
    np.testing.assert_allclose(rgb.numpy(), rgb_p.numpy(), atol=2e-4 if dtype == "fp32" else 2e-3,
                               rtol=0)
