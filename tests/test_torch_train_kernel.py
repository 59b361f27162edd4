"""K3 on the CPU: its plain version, and the arithmetic of its CUDA kernel
replayed from the packed buffers, against the JAX package's fused Pallas
train kernel (make_nerf_train_apply) in interpret mode, with JAX's
parameters carried across; the pattern and bars of
tests/test_train_kernel.py: forward max abs <= 4e-3, every gradient leaf
(dX included) within 2e-2 of its max |ref|, at row counts on and off the
JAX kernel's 64-row tile. On a CPU tensor the wrapper runs the plain
version and launches nothing."""

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
    X = torch.zeros(N, 128, device=dev)
    X[:, :n_in] = bf(x)
    hs = [bf(torch.relu(X @ Fm["pts.0"] + v(P.b[0], W)))]
    for i in range(1, D):
        z = hs[-1] @ Fm[f"pts.{i}"]
        if (P.skip_mask >> (i - 1)) & 1:
            z = z + X @ Fm[f"pts.{i}.x"]
        hs.append(bf(torch.relu(z + v(P.b[i], W))))
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
        if (P.skip_mask >> (i - 1)) & 1:
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


def _setup(depth, width, skips, rows, seed):
    jdef = JNeRFDef(depth=depth, width=width, input_ch=63, input_ch_views=27, skips=skips)
    params = jdef.init(jax.random.PRNGKey(seed))
    tdef = from_jax_params(NeRFDef(depth, width, 63, 27, 4, skips),
                           jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (rows, 90)).astype(np.float32)
    g = rng.standard_normal((rows, 4)).astype(np.float32) / (rows * 4)
    return jdef, params, tdef, x, g


def _check(out, grads, out_ref, grads_ref):
    assert float(np.abs(out - out_ref).max()) <= 4e-3
    for name, ref in grads_ref.items():
        got = grads[name].reshape(ref.shape)
        rel = float(np.abs(got - ref).max()) / (float(np.abs(ref).max()) + 1e-12)
        assert rel <= 2e-2, (name, rel)


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
    wide), and 384 and 512, whose products wider than 256 columns the
    kernels run in two passes (the streams carry them pass by pass)."""
    jdef, params, tdef, x, g = _setup(depth, width, skips, 200, width)
    out_ref, grads_ref = _jax_kernel_grads(jdef, params, x, g)
    k3 = NerfTrainKernel(tdef)
    assert any("@256" in what for what, _, _ in k3.plan[0]) == (width > 256)
    with torch.no_grad():
        out, grads, _ = k3_replay(k3, tdef, torch.from_numpy(x), torch.from_numpy(g))
    grads_ref = {k: v for k, v in grads_ref.items() if k in grads}
    assert len(grads_ref) == len(grads) == 1 + depth + 4
    _check(out.numpy(), {k: v.numpy() for k, v in grads.items()}, out_ref, grads_ref)


def test_kernel_width_is_checked():
    with pytest.raises(ValueError, match="width in \\(128, 256, 384, 512\\), got 640"):
        NerfTrainKernel(NeRFDef(4, 640, 63, 27, 4, (2,)))


@pytest.mark.parametrize("shape,routed", [((8, 256, 63, 27), True), ((8, 512, 63, 27), True),
                                          ((8, 128, 63, 27), True), ((8, 640, 63, 27), None),
                                          ((8, 256, 99, 36), None), ((8, 96, 63, 27), False)])
def test_train_step_routes_every_nerf_jax_routes(shape, routed):
    """On a CUDA device with --bf16 and --fusedTrainKernel 1, every NeRF the
    JAX package sends through its TPU kernel (width a multiple of 128) goes
    through K3, or raises (routed None) where K3 does not take its shape;
    other widths stay on the plain path, as in the JAX package. Builds the
    wrappers only: nothing is launched."""
    from types import SimpleNamespace
    from adanerf_tpu_torch.models.mlp import BaseNetDef
    from adanerf_tpu_torch.train_state import TrainState
    ts = TrainState.__new__(TrainState)
    ts.config_file = SimpleNamespace(bf16=True, fusedTrainKernel=1)
    ts.device = torch.device("cuda")
    ts.models = [BaseNetDef(8, 256, 90, 128, ""), NeRFDef(*shape, 4, (4,))]
    if routed is None:
        with pytest.raises(ValueError, match="ROADMAP Queue 2, K3"):
            ts.train_apply_fns()
        return
    fns = ts.train_apply_fns()
    assert (fns is not None) == routed
    if routed:
        assert fns[0] is None and isinstance(fns[1], NerfTrainKernel)
