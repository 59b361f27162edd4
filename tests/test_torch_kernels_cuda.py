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
from torch_wide_export import write_wide_export

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
@pytest.mark.parametrize("name", ["ndc", "mscene"])
def test_shading_rays_and_same_bin_rays_match_plain(name):
    """On an NDC export K1's front gives the plain version's shading rays
    bit for bit at a rotated pose (the ray setup rounds each product and
    sum as ``realtime.py::world_dirs`` and ``ndc_rays`` do; a view-cell
    export's are sphere exits, which ``torch.sum`` adds in its own order),
    and on both every fp32 ray
    that keeps the plain version's bins within 2e-4 of it: an NDC sample's
    high-frequency position encode turns one ulp of its ray into up to
    2.6e-4 of colour, which fused multiply-adds in the ray setup gave."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rt, scene = tviewer.build_renderer_from_export(EXPORTS[name], dtype_str="fp32",
                                                   device="cuda")
    dirs = tviewer.frame_directions(scene, 400, 400, "cuda")
    pose = np.asarray(tviewer.orbit_poses(scene.view_cell_center,
                                          0.4 * scene.view_cell_radius, 8)[3], np.float32)
    a = 0.3
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                   np.float32)
    mk = MegakernelCompact(rt)
    o_k, d_k, z_k, _, c_k = mk.front(dirs, pose, rot)
    pose_t, rot_t = torch.from_numpy(pose).cuda(), torch.from_numpy(rot).cuda()
    with torch.no_grad():
        o_p, d_p, z_p, _, m_p = rt._oracle_stage(pose_t, rot_t, dirs)
    assert not rt.use_ndc or (torch.equal(o_k, o_p) and torch.equal(d_k, d_p))
    rgb_k, cnt_k = mk(dirs, pose, rot)
    rgb_p, cnt_p = mk.plain(dirs, pose_t, rot_t)
    live = torch.arange(mk.params.S, device="cuda")[None] < c_k[:, None]
    same = (cnt_k == cnt_p) & ((torch.where(live, z_k, 0) - torch.where(m_p, z_p, 0)).abs()
                               .max(dim=1).values <= 1e-6)
    err = float((rgb_k - rgb_p).abs()[same].max())
    print(f"{name}: {int(same.sum())} of {dirs.shape[0]} rays keep the plain version's bins, "
          f"rgb max abs err there {err:.3e}")
    assert int((~same).sum()) <= dirs.shape[0] // 10000 and err <= 2e-4


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


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 384, 512])
def test_frame_kernels_match_plain_at_other_widths(tmp_path, width):
    """K1 and K2 at the other MLP widths, on a seeded export of 8-layer MLPs
    (tests/torch_wide_export.py): in fp32 K1 against its plain version
    (test_cuda_kernel_matches_plain's bars) and K2 against K1 (counts
    exact, rgb within 1.5e-7); in bf16 K1 against its plain version at 40
    dB and K2 bit for bit equal to K1."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    export = write_wide_export(tmp_path / "export", width, width, depth=(8, 8))
    for dtype in ("fp32", "bf16"):
        rt, scene = tviewer.build_renderer_from_export(export, dtype_str=dtype, device="cuda")
        dirs, pose, rot = _frame_inputs(scene, 16384)
        dirs = dirs.cuda()
        k1, k2 = MegakernelCompact(rt), MegakernelDense(rt)
        before = (MegakernelCompact.launches, MegakernelDense.launches)
        rgb1, cnt1 = k1(dirs, pose, rot)
        rgb2, cnt2 = k2(dirs, pose, rot)
        assert (MegakernelCompact.launches, MegakernelDense.launches) == \
            (before[0] + 1, before[1] + 1)
        rgb_p, cnt_p = k1.plain(dirs, torch.from_numpy(pose).cuda(),
                                torch.from_numpy(rot).cuda())
        assert torch.equal(cnt2, cnt1)
        agree = cnt1 == cnt_p
        print(f"width {width} {dtype}: counts differ on {int((~agree).sum())} rays, "
              f"max |K1 - plain| {float((rgb1 - rgb_p).abs()[agree].max()):.3e}")
        if dtype == "fp32":
            assert int((~agree).sum()) <= dirs.shape[0] // 10000
            assert float((rgb1 - rgb_p).abs()[agree].max()) <= 2e-4
            assert float((rgb2 - rgb1).abs().max()) <= 1.5e-7
        else:
            mse = float(((rgb1.clamp(0, 1) - rgb_p.clamp(0, 1)) ** 2).mean())
            assert mse == 0 or -10 * np.log10(mse) >= 40.0
            assert torch.equal(rgb2, rgb1)


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


def k3_against_plain(rows, width=256):
    """K3 and its plain version on the 8-layer NeRF (8x256 unless width says
    otherwise) with seeded initial weights and inputs in the encoding's
    range [-1, 1], both differentiated through mean((out - t)^2) with
    targets from a numpy seed (nerf_train_check.compare)."""
    nerf = NeRFDef(8, width, 63, 27, 4, (4,))
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
@pytest.mark.parametrize("width,rows", [(128, 4096), (128, 130), (384, 4096), (384, 40000),
                                        (512, 4096), (512, 40000)])
def test_nerf_train_kernel_matches_plain_at_other_widths(width, rows):
    """The same check at K3's other widths: 128 (a 64-wide views layer),
    384 and 512 (every product wider than 256 columns in two wgmma passes,
    one x buffer, and at 512 a 2-stage weight ring), with
    nerf_train_check's caps for the width. At 384 and 512 a leaf's bar
    needs thousands of rows: at 130 rows the few rows whose relu signs
    differ (6 to 11) move views.0.w's gradient by 7e-2 to 9e-2 of its max,
    while the plain version with the kernel's bf16 outputs holds every
    leaf within 8.4e-3 there (PERF.md §6)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    res = k3_against_plain(rows, width)
    ok, lines = nerf_train_check.verdict(res)
    print(f"width {width}, {rows} rows:\n  " + "\n  ".join(lines + res["report"]))
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


@pytest.mark.cuda
def test_two_gloo_ranks_step_through_k3(tmp_path):
    """The data-parallel step (parallel/mesh.py) with two gloo ranks sharing
    the card, configs/dense_training.ini as shipped on demo/mscene (2 x
    2048 rays at 128 samples): each rank launches K3 once forward and once
    backward a step at its half of the rows, both ranks end bit for bit
    equal, and the group's gradients of the first step agree with the
    one-process K3 step's within 2e-2 of each leaf's max (the bar
    chip_smoke.py holds a train step to). The oracle's L1 loss has sign
    gradients, which flip where its output meets its target within a
    rounding; the ranks' oracle GEMMs have other row counts than the
    one-process one, so on a small batch a few flips weigh more: the
    batch is the shipped one."""
    _need_card()
    from adanerf_tpu_torch.parallel import check, mesh
    argv = ["-c", os.path.join(ROOT, "configs", "dense_training.ini"),
            "-data", os.path.join(ROOT, "demo", "mscene"), "-log", str(tmp_path / "logs"),
            "--bf16", "--randomSeed", "0",
            "--epochsLockWeightsBefore", "-1", "--epochsLockWeightsBefore", "-1"]
    mesh.run_ranks(check.rank_steps, (argv, 2, 1, str(tmp_path)), ["cuda:0", "cuda:0"],
                   str(tmp_path), timeout=600)
    ranks = check.rank_records(str(tmp_path), 2)
    ref = check.one_process_steps(argv, "cuda", 1, 1)
    for r in ranks:
        assert r["k3_launches"].tolist() == [2, 2] and int(r["k3_rows"]) == 2 * 1024 * 128
    for k in (k for k in ranks[0] if k.startswith("param/")):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    for k in (k for k in ref if k.startswith("grad/")):
        rel = float(np.abs(ranks[0][k] - ref[k]).max()) / (float(np.abs(ref[k]).max()) + 1e-20)
        assert rel <= 2e-2, (k, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", [MegakernelCompact, MegakernelDense])
def test_four_slice_frame_is_the_whole_frame(kind):
    """A 200x200 bf16 frame of trained_mscene_export cut into 4 padded
    slices on one card (parallel/render.py) equals the whole frame's
    launch bit for bit, rgb and counts; each slice launches the kernel."""
    _need_card()
    from adanerf_tpu_torch.parallel.render import ShardedFrame
    rt, scene = tviewer.build_renderer_from_export(EXPORTS["mscene"], dtype_str="bf16",
                                                   device="cuda")
    dirs, pose, rot = _frame_inputs(scene, 200 * 128)
    dirs = dirs[:200 * 200 // 2 + 7].cuda()  # a count the slices must pad
    k = kind(rt)
    rgb, counts = k(dirs, pose, rot)
    frame = ShardedFrame(k, ["cuda:0"] * 4, dirs)
    before = kind.launches
    rgb_s, counts_s = frame(pose, rot)
    assert kind.launches == before + 4
    assert torch.equal(counts_s, counts) and torch.equal(rgb_s, rgb)
