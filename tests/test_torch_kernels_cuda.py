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


U = 2.0 ** -24  # unit roundoff of fp32


def _gamma(n):
    """Bound on the relative error of an n-term fp32 sum (Higham's gamma_n)."""
    return n * U / (1 - n * U)


def k3_layers(k3, nerf, x, relu_outs, feature):
    """Each relu layer of K3's recomputed forward checked against float64 sums
    of its own bf16 inputs: returns [(name, z64, bound, kernel output)], z64
    the exact pre-activation and bound the fp32 sum's error bound, after
    asserting that the kernel's bf16 output is relu(z) rounded to bf16 within
    that bound and its sign is z64's wherever |z64| exceeds it."""
    f64 = torch.float64
    ic, n_in = nerf.input_ch, k3.n_in
    xb = x.to(torch.bfloat16).to(f64)

    def bfw(p):
        return p.detach().to(torch.bfloat16).to(f64)
    layers, h = [], None
    for i, layer in enumerate(nerf.pts):
        a = xb[:, :ic] if i == 0 else h
        if i > 0 and (i - 1) in nerf.skips:
            a = torch.cat([xb[:, :ic], h], 1)
        h = relu_outs[i].to(f64)
        layers.append((f"pts.{i}", a, layer, h, True))
    layers.append(("feature", h, nerf.feature, feature.to(f64), False))
    layers.append(("views.0", torch.cat([feature.to(f64), xb[:, ic:n_in]], 1), nerf.views[0],
                   relu_outs[-1].to(f64), True))
    out = []
    for name, a, layer, h_k, relu in layers:
        w, b = bfw(layer.w), layer.b.detach().to(f64)
        z = a @ w + b
        bound = _gamma(a.shape[1] + 1) * (a.abs() @ w.abs() + b.abs())
        ref = z.clamp(min=0) if relu else z
        assert bool(((h_k - ref).abs() <= 2.0 ** -8 * ref.abs() + bound).all()), name
        if relu:
            sure = z.abs() > bound
            assert torch.equal((h_k > 0)[sure], (z > 0)[sure]), name
            out.append((name, z, bound, h_k))
    return out


def k3_against_plain(rows):
    """K3 and its plain version on the 8x256 NeRF with seeded initial
    weights and inputs in the encoding's range [-1, 1], both differentiated
    through mean((out - t)^2) with targets from a numpy seed. Returns a dict: the
    outputs and grads [dX, leaves...] of the kernel (k), the plain version
    (p) and the plain version with every relu's sign forced to the kernel's
    (f); the rows where the two sides' relu signs differ; report lines.
    Checks the kernel's recomputed forward layer by layer (k3_layers) on the
    way."""
    nerf = NeRFDef()
    nerf.reset_parameters(torch.Generator().manual_seed(rows))
    nerf = nerf.cuda()
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.uniform(-1, 1, (rows, 90)).astype(np.float32)).cuda()
    t = torch.from_numpy(rng.standard_normal((rows, 4)).astype(np.float32)).cuda()
    k3 = NerfTrainKernel(nerf)
    names = [n for n, _ in nerf.named_parameters()]
    leaves = list(nerf.parameters())
    relus = list(nerf.pts) + list(nerf.views)

    def grads(fn, hook=None):
        hooks = [m.register_forward_hook(hook) for m in relus] if hook else []
        xr = x.clone().requires_grad_(True)
        out = fn(xr)
        for h in hooks:
            h.remove()
        g = torch.autograd.grad(torch.mean((out - t) ** 2), out, retain_graph=True)[0]
        return out.detach(), g, torch.autograd.grad(out, [xr] + leaves, g)

    f0, b0 = NerfTrainKernel.forward_launches, NerfTrainKernel.backward_launches
    out_k, g_out, g_k = grads(k3)
    launched = (NerfTrainKernel.forward_launches - f0, NerfTrainKernel.backward_launches - b0)
    pre = []  # the plain version's pre-activations, in call order
    out_p, _, g_p = grads(k3.plain, lambda m, a, z: pre.append(z.detach()))

    # the kernel's own relu outputs, from its backward's scratch
    wts, bias = k3.pack(dict(nerf.named_parameters()), x.device)
    scratch = k3.new_scratch(rows, x.device)
    dx, _ = k3.backward_kernel(x, g_out, wts, bias,
                               list(zip(names, [p.shape for p in leaves])), scratch)
    assert torch.equal(dx, g_k[0])  # the same cotangent, a deterministic kernel
    feature = scratch[k3._base(rows).s_feat:][:rows * 256].view(rows, 256)
    layers = k3_layers(k3, nerf, x, k3.relu_outputs(scratch, rows), feature)
    flips = torch.zeros(rows, dtype=torch.bool, device=x.device)
    report = []
    for (name, z, bound, h_k), z_p in zip(layers, pre):
        differ = (h_k > 0) != (z_p > 0)
        flips |= differ.any(1)
        for r, c in differ.nonzero().tolist():
            report.append(f"row {r}: {name} unit {c}: pre-activation {float(z[r, c]):.3e} "
                          f"(float64 of the kernel's inputs), {float(z_p[r, c]):.3e} (plain), "
                          f"fp32 bound {float(bound[r, c]):.3e}")
    signs = iter([h_k > 0 for _, _, _, h_k in layers])

    def force(m, a, z):  # the value keeps its size, the sign is the kernel's
        differ = (z > 0) != next(signs)
        return z - 2 * torch.where(differ, z.detach(), torch.zeros_like(z))
    out_f, _, g_f = grads(k3.plain, force)
    return dict(names=names, launched=launched, out_k=out_k, out_p=out_p, out_f=out_f,
                g_k=g_k, g_p=g_p, g_f=g_f, flips=flips, report=report)


def _leaf_rel(ref, got):
    return float((ref - got).abs().max()) / (float(ref.abs().max()) + 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4096, 1000, 130])
def test_nerf_train_kernel_matches_plain(rows):
    """K3 against its plain version (the module's bf16 forward under
    autograd), at row counts on and off the 64-row tile (k3_against_plain).
    Bars of the TPU kernel's own test (tests/test_train_kernel.py), whose
    outputs have this O(1) scale: forward max abs <= 4e-3; every weight and
    bias gradient within 2e-2 of the leaf's max |ref|.

    dX is held per row. Every layer of the kernel's recomputed forward is
    first checked against float64 sums of its own inputs (k3_layers). Where
    a pre-activation lies near 0, the kernel and the plain version (which
    sum in different orders, and whose inputs may differ by a bf16 rounding
    flip upstream) may take opposite relu signs; the row then passes or
    drops that unit's whole cotangent, and its dX differs by as much as that
    unit carries, while the weight gradients, sums over all rows, barely
    move. So every dX element is held within 2e-2 of max |dX| except in the
    rows where the two sides' relu signs differ, which are printed; and the
    plain version run with the kernel's relu signs is held to the kernel
    at the same bars on every leaf, every dX element included."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    res = k3_against_plain(rows)
    assert res["launched"] == (1, 1)
    g_k, g_p, g_f = res["g_k"], res["g_p"], res["g_f"]
    rel = (g_k[0] - g_p[0]).abs() / float(g_p[0].abs().max())
    bad_rows = (rel > 2e-2).any(1)
    leaves = {n: (_leaf_rel(a, b), _leaf_rel(c, b))
              for n, a, b, c in zip(res["names"], g_p[1:], g_k[1:], g_f[1:])}
    worst = max((v[0], n) for n, v in leaves.items())
    worst_f = max((v[1], n) for n, v in leaves.items())
    rel_f = (g_k[0] - g_f[0]).abs() / float(g_f[0].abs().max())
    print(f"{rows} rows: forward max abs err {float((res['out_k'] - res['out_p']).abs().max()):.3e}; "
          f"worst leaf {worst[1]} {worst[0]:.3e}; dX max rel err {float(rel.max()):.3e}, "
          f"{int((rel > 2e-2).sum())} elements in {int(bad_rows.sum())} rows beyond 2e-2; "
          f"relu sign differences in {int(res['flips'].sum())} rows:\n  "
          + "\n  ".join(res["report"]))
    for r in bad_rows.nonzero().flatten().tolist():
        print(f"  row {r}: dX max rel err {float(rel[r].max()):.3e}")
    print(f"  with the kernel's relu signs: forward max abs err "
          f"{float((res['out_k'] - res['out_f']).abs().max()):.3e}, worst leaf {worst_f[1]} "
          f"{worst_f[0]:.3e}, dX max rel err {float(rel_f.max()):.3e}")
    assert float((res["out_k"] - res["out_p"]).abs().max()) <= 4e-3
    assert worst[0] <= 2e-2, worst
    assert not bool((bad_rows & ~res["flips"]).any())
    assert float((res["out_k"] - res["out_f"]).abs().max()) <= 4e-3
    assert worst_f[0] <= 2e-2 and float(rel_f.max()) <= 2e-2, (worst_f, float(rel_f.max()))
