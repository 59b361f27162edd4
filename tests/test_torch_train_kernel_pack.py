"""The layouts K3's tensor-core kernels read (ops/kernels/nerf_train.py).

The kernels run only on the card; these tests hold here what they read:
the forward and backward weight streams, walked by their plan (the mirror
of csrc/nerf_train.cu::k3_produce), un-tile bit for bit to every matrix of
the NeRF and every transposed one, with zero padding; the scratch layout
round-trips and puts each element where the CUDA source's tile_off does;
the weight-gradient table, run in torch on the replayed activations laid
out as the chain kernel writes them, gives the replay's weight gradients,
and with the bias-partial columns it covers every leaf exactly once."""

import math

import numpy as np
import pytest
import torch

from adanerf_tpu_torch.models.mlp import NeRFDef
from adanerf_tpu_torch.ops.kernels import nerf_train as nt
from adanerf_tpu_torch.ops.kernels.megakernel_compact import swizzle128, unpack_chunks
from test_torch_train_kernel import k3_replay

# (depth, skips[, width[, input_ch]]): the fused kernels' shapes, then the
# wide path's (wider than 512, 20 layers, 123 + 27 = 150 input columns)
SHAPES = {"8x256": (8, (4,)), "5x256, skips 1 and 3": (5, (1, 3)),
          "4x128, skip 2": (4, (2,), 128), "3x384, skip 0": (3, (0,), 384),
          "3x512, skip 1": (3, (1,), 512), "3x640, skip 1": (3, (1,), 640),
          "2x1024, skip 0": (2, (0,), 1024), "20x128, skips 4 and 12": (20, (4, 12), 128),
          "4x256, 150 columns, skip 2": (4, (2,), 256, 123)}


def _nerf(depth, skips, seed=0, width=256, ic=63):
    nerf = NeRFDef(depth, width, ic, 27, 4, skips)
    nerf.reset_parameters(torch.Generator().manual_seed(seed))
    return nerf


def _bits(a):
    return torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16).view(torch.int16).numpy()


def _pad(a, rows, cols, at=(0, 0)):
    out = np.zeros((rows, cols), np.float32)
    out[at[0]:at[0] + a.shape[0], at[1]:at[1] + a.shape[1]] = a
    return out


def _expected(nerf, xw):
    """{plan name: (K, N) matrix} as the kernels multiply by it (x padded to
    xw columns)."""
    p = {n: v.detach().numpy() for n, v in nerf.named_parameters()}
    ic, W = nerf.input_ch, nerf.width
    out = {"pts.0": _pad(p["pts.0.w"], xw, W), "feature": p["feature.w"],
           "views.f": p["views.0.w"][:W],
           "views.x": _pad(p["views.0.w"][W:], xw, W // 2, at=(ic, 0))}
    for i in range(1, nerf.depth):
        w = p[f"pts.{i}.w"]
        if (i - 1) in nerf.skips:
            out[f"pts.{i}"], out[f"pts.{i}.x"] = w[ic:], _pad(w[:ic], xw, W)
        else:
            out[f"pts.{i}"] = w
    for k in list(out):
        out[k + "^T"] = out[k].T
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
def test_weight_streams_untile_to_every_matrix(shape):
    depth, skips, *rest = SHAPES[shape]
    nerf = _nerf(depth, skips, 0, *rest)
    W = nerf.width
    k3 = nt.NerfTrainKernel(nerf)
    assert k3.wide == (W > 256 or k3.n_in > 128)
    assert k3.xw == (128 if not k3.wide else 64 * math.ceil(k3.n_in / 64))
    fs, bs, vec = k3.pack(dict(nerf.named_parameters()), "cpu")
    assert fs.dtype == bs.dtype == torch.bfloat16 and vec.dtype == torch.float32
    want = _expected(nerf, k3.xw)
    fwd, bwd = k3.plan
    # the walk the producer takes: layer 0 on x, layer i on [h, x] where it
    # takes x, feature, views; then the backward chain's transposes
    # (a product wider than 256 columns comes pass by pass: pass c0's
    # columns of each of its inputs, named what@c0)
    names = [[w.split("@")[0] for w, _, _ in plan] for plan in (fwd, bwd)]
    assert names[0][:2] == (["pts.0", "pts.1"] if W <= 256 else ["pts.0"] * 2)
    assert names[0][-2] == "views.f"
    assert [w for w in dict.fromkeys(names[1])][:3] == ["views.x^T", "views.f^T", "feature^T"]
    assert bwd[-1][0] == "pts.0^T"
    n_x = len({w for w in names[1] if w.endswith(".x^T") and w.startswith("pts")})
    assert n_x == len(skips)
    for stream, plan in ((fs, fwd), (bs, bwd)):
        flat, off = stream.view(torch.int16).numpy(), 0
        for what, K, N in plan:
            assert K % 64 == 0 and N in (64, 128, 192, 256), what
            name, _, c0 = what.partition("@")
            got = unpack_chunks(flat, off, K, N)
            c0 = int(c0 or 0)
            np.testing.assert_array_equal(got, _bits(want[name][:, c0:c0 + N]), err_msg=what)
            # each chunk is one bulk copy of N * 128 bytes at a 1024-byte
            # aligned place of the stream
            assert (off * 2) % 1024 == 0
            off += K * N
        assert off == flat.size
    P = k3.params
    p = {n: v.detach() for n, v in nerf.named_parameters()}
    for i in range(depth):
        torch.testing.assert_close(vec[k3.b[i]:k3.b[i] + W], p[f"pts.{i}.b"], rtol=0, atol=0)
    for off, name, n in ((P.bf, "feature.b", W), (P.bv, "views.0.b", W // 2),
                         (P.brgb, "rgb.b", 3), (P.ba, "alpha.b", 1)):
        assert off % 4 == 0
        torch.testing.assert_close(vec[off:off + n], p[name], rtol=0, atol=0)
    for off, name in ((P.wa, "alpha.w"), (P.wrgb, "rgb.w")):
        w = p[name].reshape(-1)
        torch.testing.assert_close(vec[off:off + w.numel()], w.to(torch.bfloat16).float(),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("N", [130, 256, 1000])
@pytest.mark.parametrize("F", [64, 128, 192, 256, 512])
def test_scratch_layout_round_trips(N, F):
    T = 2 * math.ceil(N / 128)
    a = torch.from_numpy(np.random.default_rng(N + F).standard_normal((N, F)).astype(np.float32))
    flat = nt.tile_rows(a, T)
    assert flat.numel() == T * 64 * F
    torch.testing.assert_close(nt.untile_rows(flat, T, F, N), a, rtol=0, atol=0)
    # where csrc/nerf_train.cu::tile_off puts (row s of tile t, feature f)
    rng = np.random.default_rng(F)
    for n, f in zip(rng.integers(0, N, 50), rng.integers(0, F, 50)):
        t, s = divmod(int(n), 64)
        pos = t * 64 * F + (f >> 6) * 4096 + (f & 63) * 64 + ((((s >> 3) ^ f) & 7) << 3) + (s & 7)
        assert float(flat[pos]) == float(a[n, f])
    # the padding rows are zero
    assert float(nt.untile_rows(flat, T, F, T * 64)[N:].abs().sum()) == 0.0


def _run_table(k3, N, acts):
    """The weight-gradient kernels (k3_dw, then k3_reduce) replayed in torch
    from the table's raw fields on a scratch filled as the chain writes it.
    Returns (grads buffer, how many times each element was written)."""
    lay, T = k3.scratch_layout(N), k3.tiles(N)
    scr = torch.zeros(lay[""][0])
    for name, (off, F) in lay.items():
        if name:
            scr[off:off + T * 64 * F] = nt.tile_rows(acts[name], T)
    gbuf = torch.zeros(k3.grad_size, dtype=torch.float64)
    hits = torch.zeros(k3.grad_size, dtype=torch.int64)
    t = torch.arange(T)
    for d in k3.dw_tiles(N):
        idx_b = torch.from_numpy(swizzle128(d.n)).reshape(-1)
        B = scr[d.b + t[:, None] * d.b_stride + idx_b[None, :]].view(T, d.n, 64)
        for g in range(d.nslab):
            idx_a = torch.from_numpy(swizzle128(64)).reshape(-1)
            A = scr[d.a + t[:, None] * d.a_stride + g * 4096 + idx_a[None, :]].view(T, 64, 64)
            part = torch.einsum("tfr,tmr->fm", A.double(), B.double())
            k = d.k0 + 64 * g + torch.arange(64)
            r = torch.nonzero((k >= d.k_lo) & (k < d.k_hi)).flatten()
            at = (d.dst + (k[r] - d.k_lo) * d.ldo)[:, None] + torch.arange(d.m_valid)[None, :]
            gbuf[at.flatten()] = part[r, :d.m_valid].flatten()
            hits.index_add_(0, at.flatten(), torch.ones(at.numel(), dtype=torch.int64))
    return gbuf, hits


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("N", [200, 128])
def test_dw_table_covers_every_leaf_once(shape, N):
    depth, skips, *rest = SHAPES[shape]
    nerf = _nerf(depth, skips, N, *rest)
    k3 = nt.NerfTrainKernel(nerf)
    rng = np.random.default_rng(N)
    x = torch.from_numpy(rng.uniform(-1, 1, (N, k3.n_in)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((N, 4)).astype(np.float32))
    with torch.no_grad():
        _, grads, acts = k3_replay(k3, nerf, x, g)
    gbuf, hits = _run_table(k3, N, acts)
    P = k3.params
    got = k3.grads_from(gbuf)
    # the table writes every weight element outside the bias-partial columns
    # (the biases, alpha.w and rgb.w, summed by the chain kernel) once
    assert bool((hits[P.bp_width:] == 1).all()) and int(hits[:P.bp_width].sum()) == 0
    cols = torch.zeros(P.bp_width, dtype=torch.int64)
    for name, off in k3.grad_slices.items():
        n = math.prod(k3.shapes[name])
        if off < P.bp_width:
            cols[off:off + n] += 1
        else:
            assert name.endswith(".w") and name not in ("alpha.w", "rgb.w")
    assert bool((cols == 1).all())
    assert sorted(k3.grad_slices) == sorted(k3.names)
    for name, ref in grads.items():
        if name == "x" or k3.grad_slices[name] < P.bp_width:
            continue
        # the same products, summed per 64-row tile in float64 here
        torch.testing.assert_close(got[name].float(), ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


def test_dw_table_shape_at_the_train_step():
    """At the dense step's 524,288 rows: 21 output tiles (pts.0, 7 trunk
    layers of two, layer 5's x rows, feature and views of two, views' x
    rows) in 32 row slices; the scratch is 5.23 GB."""
    k3 = nt.NerfTrainKernel(_nerf(8, (4,)))
    N = 524288
    tiles = k3.dw_tiles(N)
    assert len(tiles) == 21
    assert sum(t.nslab for t in tiles) == 1 + 7 * 4 + 1 + 4 + 4 + 2  # 64-row slabs
    assert math.ceil(k3.tiles(N) / nt.DW_SLICE_TILES) == 32
    assert k3.scratch_layout(N)[""][0] * 2 == 5_234_491_392


@pytest.mark.parametrize("shape", list(SHAPES))
def test_layer_offsets_are_the_kernels_strides(shape):
    """The fused kernels compute a trunk layer's offsets from the first
    layer's (csrc/nerf_train.cu, lt_*): its bias and bias-partial columns
    l widths further, its output's and its cotangent's scratch regions l
    times K3Params::s_step further; layer l takes x where bit l - 1 of
    K3Params::skip_bits is set."""
    depth, skips, *rest = SHAPES[shape]
    k3 = nt.NerfTrainKernel(_nerf(depth, skips, 0, *rest))
    N, W = 1000, k3.width
    lay = k3.scratch_layout(N)
    step = k3.tiles(N) * 64 * W
    for i in range(depth):
        assert k3.b[i] == k3.bp[i] == i * W
        assert lay[f"h.{i}"][0] == lay["h.0"][0] + i * step
        assert lay[f"g.{i}"][0] == lay["g.0"][0] + i * step
    assert k3.skip == [int(i > 0 and (i - 1) in skips) for i in range(depth)]
    assert k3.params.skip_bits == sum(1 << s for s in skips)
