"""K3 on the CPU: its plain version, and the arithmetic of its CUDA kernel
replayed from the packed buffers, against the JAX package's fused Pallas
train kernel (make_nerf_train_apply) in interpret mode, with JAX's
parameters carried across; the pattern and bars of
tests/test_train_kernel.py: forward max abs <= 4e-3, every gradient leaf
(dX included) within 2e-2 of its max |ref|, at row counts on and off the
JAX kernel's 64-row tile. On a CPU tensor the wrapper runs the plain
version and launches nothing."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adanerf_tpu.models.mlp import NeRFDef as JNeRFDef
from adanerf_tpu.ops.pallas.train_kernel import make_nerf_train_apply
from adanerf_tpu_torch.models.mlp import NeRFDef
from adanerf_tpu_torch.ops.kernels.nerf_train import NerfTrainKernel, unpack_stream
from adanerf_tpu_torch.utils.weights import flatten_params, from_jax_params


def k3_replay(kernel, nerf, x, g):
    """The TPU kernel's arithmetic (train_kernel.py: bf16 operands, fp32
    sums, cotangents rounded before each product) replayed in PyTorch from
    K3's packed buffers, on x's device: every matrix is un-tiled from the
    forward and backward weight streams by walking their plan, as the CUDA
    source walks them, and the biases and heads' weights are read from the
    vector buffer by their offsets (a product wider than 256 columns put
    back together from its passes). Returns (out, {leaf: grad}, acts) for
    the weight matrices and x, given the cotangent g of out; acts holds the
    bf16 matrices the backward's scratch carries, by ``scratch_layout``
    name."""
    def bf(v):
        return v.to(torch.bfloat16).float()
    P = kernel.params
    fs, bs, vec = kernel.pack(dict(nerf.named_parameters()), x.device)

    def walk(stream, plan):
        return {k: torch.from_numpy(m).to(x.device)
                for k, m in unpack_stream(stream.float().cpu().numpy(), plan).items()}
    Fm, Bm = walk(fs, kernel.plan[0]), walk(bs, kernel.plan[1])

    def v(off, n):
        return vec[off:off + n]
    W, D, ic, n_in = kernel.width, nerf.depth, nerf.input_ch, kernel.n_in
    H = W // 2
    N, dev = x.shape[0], x.device
    X = torch.zeros(N, kernel.xw, device=dev)
    X[:, :n_in] = bf(x)
    hs = [bf(torch.relu(X @ Fm["pts.0"] + v(kernel.b[0], W)))]
    for i in range(1, D):
        z = hs[-1] @ Fm[f"pts.{i}"]
        if kernel.skip[i]:
            z = z + X @ Fm[f"pts.{i}.x"]
        hs.append(bf(torch.relu(z + v(kernel.b[i], W))))
    feat = bf(hs[-1] @ Fm["feature"] + v(P.bf, W))
    wa, wrgb = v(P.wa, W), v(P.wrgb, 3 * H).view(H, 3)
    alpha = hs[-1] @ wa[:, None] + v(P.ba, 1)
    hv = bf(torch.relu(feat @ Fm["views.f"] + X @ Fm["views.x"] + v(P.bv, H)))
    out = torch.cat([hv @ wrgb + v(P.brgb, 3), alpha], dim=1)
    g_rgb, g_a = bf(g[:, :3]), bf(g[:, 3:])
    g_hv = bf((g_rgb @ wrgb.t()) * (hv > 0))
    dx = g_hv @ Bm["views.x^T"]
    g_feat = bf(g_hv @ Bm["views.f^T"])
    g_h = g_feat @ Bm["feature^T"] + g_a @ wa[None, :]
    g_pre = [None] * D
    for i in range(D - 1, -1, -1):
        g_pre[i] = bf(g_h * (hs[i] > 0))
        if i == 0:
            dx = dx + g_pre[0] @ Bm["pts.0^T"]
            break
        if kernel.skip[i]:
            dx = dx + g_pre[i] @ Bm[f"pts.{i}.x^T"]
        g_h = g_pre[i] @ Bm[f"pts.{i}^T"]
    xb = bf(x)
    grads = {"x": dx[:, :n_in], "pts.0.w": xb[:, :ic].t() @ g_pre[0],
             "feature.w": hs[-1].t() @ g_feat, "alpha.w": hs[-1].t() @ g_a,
             "views.0.w": torch.cat([feat.t() @ g_hv, xb[:, ic:n_in].t() @ g_hv], 0),
             "rgb.w": hv.t() @ g_rgb}
    for i in range(1, D):
        hw = hs[i - 1].t() @ g_pre[i]
        grads[f"pts.{i}.w"] = torch.cat([xb[:, :ic].t() @ g_pre[i], hw], 0) \
            if (i - 1) in nerf.skips else hw
    acts = {"x": X, "feat": feat, "hv": hv, "g.feat": g_feat, "g.hv": g_hv}
    for i in range(D):
        acts[f"h.{i}"], acts[f"g.{i}"] = hs[i], g_pre[i]
    return out, grads, acts


def _jax_kernel_grads(jdef, params, x, g):
    apply_k = make_nerf_train_apply(jdef, tile=64, interpret=True)
    out, vjp = jax.vjp(apply_k, params, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.tree.map(np.asarray, dp)).items()}
    flat["x"] = np.asarray(dx)
    return np.asarray(out), flat


def _setup(depth, width, skips, rows, seed, ic=63):
    jdef = JNeRFDef(depth=depth, width=width, input_ch=ic, input_ch_views=27, skips=skips)
    params = jdef.init(jax.random.PRNGKey(seed))
    tdef = from_jax_params(NeRFDef(depth, width, ic, 27, 4, skips),
                           jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (rows, ic + 27)).astype(np.float32)
    g = rng.standard_normal((rows, 4)).astype(np.float32) / (rows * 4)
    return jdef, params, tdef, x, g


def _check(out, grads, out_ref, grads_ref):
    assert float(np.abs(out - out_ref).max()) <= 4e-3
    for name, ref in grads_ref.items():
        got = grads[name].reshape(ref.shape)
        rel = float(np.abs(got - ref).max()) / (float(np.abs(ref).max()) + 1e-12)
        assert rel <= 2e-2, (name, rel)


def _check_flips(out, grads, out_ref, grads_ref, width, depth):
    """_check where the two sides' fp32 sums, each in its own order (the
    JAX kernel's XLA dots; torch's GEMMs or the replay's float64 ones), may
    take a bf16 rounding or a relu sign within rounding of 0 the other way:
    such a flip moves the rest of its row and, through the row's share, the
    leaves. So nerf_train_check's bars for the kernel against its plain
    version: the forward within 4e-3 (FWD_BAR) on all rows but the share
    that nerf_train_check.caps lets differ at the NeRF's shape, within its
    bar for them on those; each leaf and dX within 2e-2 of its max
    (GRAD_BAR) on all its elements but the share of rows that caps lets
    flip, and within its dX bar for those rows on every element. (The JAX
    package's own plain bf16 path is within 2e-2 of its kernel everywhere
    at these shapes because its sums run in the kernel's XLA order: forward
    6e-8 apart at 20 layers.)"""
    from adanerf_tpu_torch.ops.kernels import nerf_train_check as check
    differ_bar, differ_share, flip_share, flip_bar, _ = check.caps(width, depth)
    row_err = np.abs(out - out_ref).max(1)
    assert float((row_err > check.FWD_BAR).mean()) <= differ_share
    assert float(row_err.max()) <= differ_bar
    for name, ref in grads_ref.items():
        rel = np.abs(grads[name].reshape(ref.shape) - ref) / (float(np.abs(ref).max()) + 1e-12)
        assert float((rel > check.GRAD_BAR).mean()) <= flip_share, (name, rel.max())
        assert float(rel.max()) <= flip_bar, (name, float(rel.max()))


@pytest.mark.parametrize("rows", [200, 130])
def test_plain_version_matches_jax_kernel(rows):
    jdef, params, tdef, x, g = _setup(4, 128, (2,), rows, 0)
    out_ref, grads_ref = _jax_kernel_grads(jdef, params, x, g)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tdef(xt, dtype=torch.bfloat16)  # K3's plain version (NerfTrainKernel.plain)
    names = [n for n, _ in tdef.named_parameters()]
    grads = torch.autograd.grad(out, [xt] + list(tdef.parameters()), torch.from_numpy(g))
    got = {n: v.numpy() for n, v in zip(["x"] + names, grads)}
    _check(out.detach().numpy(), got, out_ref, grads_ref)


@pytest.mark.parametrize("rows", [200, 130])
def test_cuda_kernel_arithmetic_matches_jax_kernel(rows):
    """The replay of nerf_train.cu's data flow from K3's packed buffers (the
    weight streams' chunk order, transposes and padding, and the vector
    buffer's offsets, as the CUDA source reads them) at the kernel's 8x256
    width."""
    jdef, params, tdef, x, g = _setup(8, 256, (4,), rows, 1)
    out_ref, grads_ref = _jax_kernel_grads(jdef, params, x, g)
    with torch.no_grad():
        out, grads, _ = k3_replay(NerfTrainKernel(tdef), tdef, torch.from_numpy(x),
                               torch.from_numpy(g))
    grads_ref = {k: v for k, v in grads_ref.items() if k in grads}
    assert len(grads_ref) == len(grads) == 1 + 8 + 4  # x, trunk, feature, alpha, views, rgb
    _check(out.numpy(), {k: v.numpy() for k, v in grads.items()}, out_ref, grads_ref)


def test_cpu_tensor_takes_the_plain_version():
    nerf = NeRFDef()
    nerf.reset_parameters(torch.Generator().manual_seed(0))
    k3 = NerfTrainKernel(nerf)
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (3, 5, 90)).astype(np.float32))
    before = (NerfTrainKernel.forward_launches, NerfTrainKernel.backward_launches)
    out = k3(x)
    assert out.shape == (3, 5, 4)
    torch.testing.assert_close(out, nerf(x, dtype=torch.bfloat16), rtol=0, atol=0)
    out.sum().backward()
    assert (NerfTrainKernel.forward_launches, NerfTrainKernel.backward_launches) == before


@pytest.mark.parametrize("width,depth,skips", [(128, 4, (2,)), (384, 3, (0,)),
                                               (512, 3, (1,))])
def test_cuda_kernel_arithmetic_matches_jax_kernel_at_other_widths(width, depth, skips):
    """The same replay at the other widths K3 takes: 128 (views layer 64
    wide, on the fused kernels), and 384 and 512, whose products wider than
    256 columns the streams carry pass by pass, as the wide path's GEMMs
    read them (csrc/wide.cu)."""
    jdef, params, tdef, x, g = _setup(depth, width, skips, 200, width)
    out_ref, grads_ref = _jax_kernel_grads(jdef, params, x, g)
    k3 = NerfTrainKernel(tdef)
    assert k3.wide == (width > 256)
    assert any("@256" in what for what, _, _ in k3.plan[0]) == (width > 256)
    with torch.no_grad():
        out, grads, _ = k3_replay(k3, tdef, torch.from_numpy(x), torch.from_numpy(g))
    grads_ref = {k: v for k, v in grads_ref.items() if k in grads}
    assert len(grads_ref) == len(grads) == 1 + depth + 4
    _check(out.numpy(), {k: v.numpy() for k, v in grads.items()}, out_ref, grads_ref)


def test_kernel_width_is_checked():
    """K3 takes every width the JAX package routes to its kernel (a multiple
    of 128; those above 512 on the wide path) and refuses any other, naming
    the JAX line that routes none."""
    for width in (640, 768, 1024):
        assert NerfTrainKernel(NeRFDef(4, width, 63, 27, 4, (2,))).wide
    assert NerfTrainKernel(NeRFDef(70, 128, 63, 27, 4, (66,))).wide  # past the fused skip bits
    with pytest.raises(ValueError, match="multiple of 128, got 96.*train_state.py:313-314"):
        NerfTrainKernel(NeRFDef(4, 96, 63, 27, 4, (2,)))


@pytest.mark.parametrize("shape,routed", [((8, 256, 63, 27), True), ((8, 512, 63, 27), True),
                                          ((8, 128, 63, 27), True), ((8, 640, 63, 27), True),
                                          ((8, 256, 99, 36), True), ((8, 96, 63, 27), False)])
def test_train_step_routes_every_nerf_jax_routes(shape, routed):
    """On a CUDA device with --bf16 and --fusedTrainKernel 1, every NeRF the
    JAX package sends through its TPU kernel (width a multiple of 128) goes
    through K3, wider ones and ones of more than 128 input columns on its
    wide path; other widths stay on the plain path, as in the JAX package.
    Builds the wrappers only: nothing is launched."""
    from types import SimpleNamespace
    from adanerf_tpu_torch.models.mlp import BaseNetDef
    from adanerf_tpu_torch.train_state import TrainState
    ts = TrainState.__new__(TrainState)
    ts.config_file = SimpleNamespace(bf16=True, fusedTrainKernel=1)
    ts.device = torch.device("cuda")
    ts.models = [BaseNetDef(8, 256, 90, 128, ""), NeRFDef(*shape, 4, (4,))]
    fns = ts.train_apply_fns()
    assert (fns is not None) == routed
    if routed:
        assert fns[0] is None and isinstance(fns[1], NerfTrainKernel)
        assert fns[1].wide == (shape[1] > 256 or shape[2] + shape[3] > 128)


# the shapes only the wide path takes: (width, depth, skips, input_ch)
WIDE = {"640": (640, 3, (1,), 63), "1024": (1024, 2, (0,), 63),
        "20 layers": (256, 20, (4, 12), 63), "150 columns": (256, 4, (2,), 123)}


@functools.lru_cache(maxsize=None)
def _wide_case(name):
    width, depth, skips, ic = WIDE[name]
    jdef, params, tdef, x, g = _setup(depth, width, skips, 200, width + depth, ic)
    return jdef, params, tdef, x, g, _jax_kernel_grads(jdef, params, x, g)


@pytest.mark.parametrize("name", list(WIDE))
def test_plain_version_matches_jax_kernel_at_wide_shapes(name):
    """K3's plain version at the shapes of the wide path against the JAX
    kernel, which takes them all (any width a multiple of 128, any depth,
    inputs padded to a multiple of 128 columns), at _check_flips' bars."""
    jdef, params, tdef, x, g, (out_ref, grads_ref) = _wide_case(name)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tdef(xt, dtype=torch.bfloat16)
    names = [n for n, _ in tdef.named_parameters()]
    grads = torch.autograd.grad(out, [xt] + list(tdef.parameters()), torch.from_numpy(g))
    got = {n: v.numpy() for n, v in zip(["x"] + names, grads)}
    _check_flips(out.detach().numpy(), got, out_ref, grads_ref, tdef.width, tdef.depth)


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_path_matches_jax_kernel(name):
    """The wide path (csrc/wide.cu) at those shapes: the stream replay
    (k3_replay: the packed matrices, x padded to 64-column blocks beyond 128
    columns) and the
    wrapper's own launch sequence, each kernel replayed on the CPU
    (tests/torch_wide_replay.py: the forward's GEMMs and heads, the
    recompute into the scratch, the heads' gradients, the chain's
    cotangents with their relu masks and bias partials, dX, then the
    weight-gradient table), against the JAX kernel at _check_flips'
    bars."""
    from torch_wide_replay import k3_backward_on_cpu, k3_forward_on_cpu
    jdef, params, tdef, x, g, (out_ref, grads_ref) = _wide_case(name)
    k3 = NerfTrainKernel(tdef)
    # a 20-layer NeRF at 256 runs the fused kernels on the card, whose
    # depth has no cap either; the wide path's sequence takes it all the same
    assert k3.wide == (name != "20 layers")
    with torch.no_grad():
        out, grads, _ = k3_replay(k3, tdef, torch.from_numpy(x), torch.from_numpy(g))
        refs = {k: v for k, v in grads_ref.items() if k in grads}
        assert len(refs) == len(grads) == 1 + tdef.depth + 4
        _check_flips(out.numpy(), {k: v.numpy() for k, v in grads.items()}, out_ref, refs,
                     tdef.width, tdef.depth)
        xt, gt = torch.from_numpy(x), torch.from_numpy(g)
        out = k3_forward_on_cpu(k3, xt)
        dx, grads = k3_backward_on_cpu(k3, xt, gt)
    grads = {k: v.numpy() for k, v in grads.items()}
    grads["x"] = dx.numpy()
    assert sorted(grads) == sorted(grads_ref)
    _check_flips(out.numpy(), grads, out_ref, grads_ref, tdef.width, tdef.depth)


# rows of the card check on the CPU: its unforced leaf bar holds a leaf's
# sum over the rows, which a row whose relu sign the two sides' fp32 sums
# take differently moves by its share (the card checks 130 to 524,288 rows)
CHECK_ROWS = 512


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_path_passes_the_card_check_against_its_plain_version(name):
    """The card's check of K3 (nerf_train_check: every layer of the
    recompute against float64 sums of its bf16 inputs, the plain version
    with the kernel's bf16 layer outputs forced in at the plain bars, the
    relu-sign rows capped, two backward calls bit for bit) with the wide
    path's launch sequence, replayed on the CPU, as the kernel side."""
    from adanerf_tpu_torch.ops.kernels import nerf_train_check as check
    from torch_wide_replay import WideStandIn
    width, depth, skips, ic = WIDE[name]
    tdef = NeRFDef(depth, width, ic, 27, 4, skips)
    tdef.reset_parameters(torch.Generator().manual_seed(width + depth))
    rng = np.random.default_rng(width + depth)
    x = torch.from_numpy(rng.uniform(-1, 1, (CHECK_ROWS, ic + 27)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((CHECK_ROWS, 4)).astype(np.float32) / CHECK_ROWS)
    res = check.compare(WideStandIn(NerfTrainKernel(tdef)), x, lambda out: g)
    ok, lines = check.verdict(res)
    assert ok, "\n".join(lines + res["report"])
