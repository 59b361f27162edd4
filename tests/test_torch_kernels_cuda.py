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
from adanerf_tpu_torch.models.mlp import NeRFDef
from adanerf_tpu_torch.ops.kernels.megakernel_compact import MegakernelCompact
from adanerf_tpu_torch.ops.kernels.megakernel_dense import MegakernelDense
from adanerf_tpu_torch.ops.kernels import nerf_train_check
from adanerf_tpu_torch.ops.kernels.nerf_train import NerfTrainKernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORTS = {"mscene": os.path.join(ROOT, "demo", "trained_mscene_export"),
           "ndc": os.path.join(ROOT, "demo", "trained_ndc_export")}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_kernels_cuda.py")


def _frame_inputs(scene, n):
    dirs = tviewer.frame_directions(scene, 128, n // 128, "cpu")
    pose = tviewer.orbit_poses(scene.view_cell_center, 0.4 * scene.view_cell_radius, 8)[1]
    return dirs, np.asarray(pose, np.float32), np.eye(3, dtype=np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("mscene", "fp32"), ("ndc", "fp32"), ("mscene", "bf16")])
def test_cuda_kernel_matches_plain(name, dtype):
    _need_card()
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



@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [None, 0.01, 1e-4])
def test_dense_kernel_matches_plain_and_k1(threshold):
    """K2 in fp32 against its plain version (counts exact, rgb within 2e-4)
    and against K1 on the same rays (counts exact, rgb within 1.5e-7: the
    live slots run the same instructions, and a dead slot adds exact
    zeros), at the export's threshold, at 0.01 and at 1e-4 (every ray at
    the sample cap)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rt, scene = tviewer.build_renderer_from_export(EXPORTS["mscene"], dtype_str="fp32",
                                                   device="cuda")
    if threshold is not None:
        rt.threshold = threshold
    dirs, pose, rot = _frame_inputs(scene, 16384)
    dirs = dirs.cuda()
    k2, k1 = MegakernelDense(rt), MegakernelCompact(rt)
    before = MegakernelDense.launches
    rgb2, cnt2 = k2(dirs, pose, rot)
    assert MegakernelDense.launches == before + 1
    rgb1, cnt1 = k1(dirs, pose, rot)
    rgb_p, cnt_p = k2.plain(dirs, torch.from_numpy(pose).cuda(), torch.from_numpy(rot).cuda())
    assert torch.equal(cnt2, cnt_p) and torch.equal(cnt2, cnt1)
    assert float((rgb2 - rgb_p).abs().max()) <= 2e-4
    assert float((rgb2 - rgb1).abs().max()) <= 1.5e-7
    # the front alone gives the same counts, and a ray's live slots first
    _, _, z, p, c = k2.front(dirs, pose, rot)
    assert torch.equal(c, cnt2) and bool(torch.isfinite(z).all())
    live = torch.arange(rt.max_samples, device="cuda")[None, :] < c[:, None]
    assert bool((z[:, 1:] > z[:, :-1])[live[:, 1:]].all()) and bool((p[~live] == 0).all())
    if threshold == 1e-4:
        assert int(cnt2.min()) == rt.max_samples


RAGGED = 16383  # not a multiple of the tensor-core kernels' 128-row tile


def _ragged_inputs(scene):
    dirs, pose, rot = _frame_inputs(scene, 16384)
    return dirs[:RAGGED].contiguous().cuda(), pose, rot


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mscene", "ndc"])
def test_bf16_tensor_core_kernel_matches_plain_on_a_ragged_batch(name):
    """K1 in bf16 (the wgmma path) against its plain bf16 version on 16,383
    rays: both round the same operands to bf16 and sum in fp32, in other
    orders, so a logit within rounding of the threshold may keep another
    bin; at most 1 ray in 1,000 may differ in count, and the frame is held
    to chip_smoke.py's 40 dB. The ragged last tile's rays are checked like
    the rest."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rt, scene = tviewer.build_renderer_from_export(EXPORTS[name], dtype_str="bf16", device="cuda")
    dirs, pose, rot = _ragged_inputs(scene)
    mk = MegakernelCompact(rt)
    rgb_k, cnt_k = mk(dirs, pose, rot)
    rgb_p, cnt_p = mk.plain(dirs, torch.from_numpy(pose).cuda(), torch.from_numpy(rot).cuda())
    assert rgb_k.shape == (RAGGED, 3) and bool(torch.isfinite(rgb_k).all())
    assert int((cnt_k != cnt_p).sum()) <= RAGGED // 1000
    mse = float(((rgb_k.clamp(0, 1) - rgb_p.clamp(0, 1)) ** 2).mean())
    assert mse == 0 or -10 * np.log10(mse) >= 40.0
    tail = slice(RAGGED - RAGGED % 128, RAGGED)  # the last, partial tile
    mse = float(((rgb_k[tail].clamp(0, 1) - rgb_p[tail].clamp(0, 1)) ** 2).mean())
    assert mse == 0 or -10 * np.log10(mse) >= 40.0


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [None, 0.01, 1e-4])
def test_bf16_dense_kernel_is_bit_identical_to_k1(threshold):
    """K2 and K1 in bf16 share the tensor-core front and shade: each output
    row of an MMA depends on its own input row and the weights only, and a
    dead slot adds exact zeros, so K2's frame equals K1's bit for bit."""
    _need_card()
    rt, scene = tviewer.build_renderer_from_export(EXPORTS["mscene"], dtype_str="bf16",
                                                   device="cuda")
    if threshold is not None:
        rt.threshold = threshold
    dirs, pose, rot = _ragged_inputs(scene)
    rgb2, cnt2 = MegakernelDense(rt)(dirs, pose, rot)
    rgb1, cnt1 = MegakernelCompact(rt)(dirs, pose, rot)
    assert torch.equal(cnt2, cnt1) and torch.equal(rgb2, rgb1)


def k3_against_plain(rows):
    """K3 and its plain version on the 8x256 NeRF with seeded initial
    weights and inputs in the encoding's range [-1, 1], both differentiated
    through mean((out - t)^2) with targets from a numpy seed
    (nerf_train_check.compare)."""
    nerf = NeRFDef()
    nerf.reset_parameters(torch.Generator().manual_seed(rows))
    nerf = nerf.cuda()
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.uniform(-1, 1, (rows, 90)).astype(np.float32)).cuda()
    t = torch.from_numpy(rng.standard_normal((rows, 4)).astype(np.float32)).cuda()
    return nerf_train_check.compare(
        NerfTrainKernel(nerf), x,
        lambda out: torch.autograd.grad(torch.mean((out - t) ** 2), out, retain_graph=True)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4096, 1000, 130, 40000])
def test_nerf_train_kernel_matches_plain(rows):
    """K3 against its plain version (the module's bf16 forward under
    autograd), at row counts on and off the 64-row tile (k3_against_plain);
    at 40,000 rows each of the card's persistent blocks walks two or three
    128-row tiles. Bars of the TPU kernel's own test
    (tests/test_train_kernel.py), whose outputs have this O(1) scale:
    forward max abs <= 4e-3; every weight and bias gradient within 2e-2 of
    the leaf's max |ref|. They hold as nerf_train_check states: on every
    row where the two sides' bf16 layer outputs agree, and on every row
    for the plain version run with the kernel's bf16 layer outputs; the
    rows where a bf16 rounding or a relu sign flips between the two sides'
    summation orders are capped in number and held to the looser bars
    stated there; and every layer of the kernel's recomputed forward is
    held on every element against float64 sums of its own inputs."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    res = k3_against_plain(rows)
    ok, lines = nerf_train_check.verdict(res)
    print(f"{rows} rows:\n  " + "\n  ".join(lines + res["report"]))
    assert res["launched"] == (1, 1)
    assert ok, lines


@pytest.mark.cuda
def test_two_nerf_step_through_k3_matches_plain(tmp_path):
    """adanerf_tpu_torch/configs/nerf_baseline.ini (a coarse and a fine
    NeRF, both 8 x 256) on demo/mscene, 2 x 256 rays a step at 16 + 32
    samples: one step launches K3 once forward and once backward for each
    net, at each stage's rows, and its loss and every gradient leaf agree
    with the plain path's (the grads within 2e-2 of the leaf's max, the bar
    chip_smoke.py holds a train step to); a second step moves both nets."""
    _need_card()
    from adanerf_tpu_torch.config import Config
    from adanerf_tpu_torch.train_state import TrainState
    torch.backends.cuda.matmul.allow_tf32 = False
    argv = ["-c", os.path.join(ROOT, "adanerf_tpu_torch", "configs", "nerf_baseline.ini"),
            "-data", os.path.join(ROOT, "demo", "mscene"), "-log", str(tmp_path), "--bf16",
            "--samples", "256", "--numRaymarchSamples", "16", "--numRaymarchSamples", "32",
            "--randomSeed", "0", "--device", "cuda"]
    ts = TrainState()
    ts.initialize(Config.init(argv=argv))
    batch, targets = ts.assemble_train_batch(ts.train_dataset, np.array([0, 1]))
    rows, launch = [], NerfTrainKernel.forward_kernel

    def keep(self, x, packed):
        rows.append(x.shape[0])
        return launch(self, x, packed)

    f0, b0 = NerfTrainKernel.forward_launches, NerfTrainKernel.backward_launches
    NerfTrainKernel.forward_kernel = keep
    try:
        losses_k, grads_k = ts.make_loss_and_grads()(batch, targets, 1)
    finally:
        NerfTrainKernel.forward_kernel = launch
    assert rows == [2 * 256 * 16, 2 * 256 * 48]
    assert (NerfTrainKernel.forward_launches - f0, NerfTrainKernel.backward_launches - b0) == (2, 2)
    ts.config_file.fusedTrainKernel = 0
    losses_p, grads_p = ts.make_loss_and_grads()(batch, targets, 1)
    ts.config_file.fusedTrainKernel = 1
    for i in range(2):
        assert abs(float(losses_k[i]) - float(losses_p[i])) <= 1e-2 * float(losses_p[i])
        for k, ref in grads_p[i].items():
            rel = float((grads_k[i][k] - ref).abs().max()) / (float(ref.abs().max()) + 1e-20)
            assert rel <= 2e-2, (i, k, rel)
    before = [{k: v.clone() for k, v in m.state_dict().items()} for m in ts.models]
    ts.make_train_step()(batch, targets, 2)
    for m, b in zip(ts.models, before):
        assert any(not torch.equal(v, b[k]) for k, v in m.state_dict().items())
