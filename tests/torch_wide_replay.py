"""The kernels of csrc/wide.cu replayed on the CPU, for the tests of the wide
path of K1, K2 and K3 (ops/kernels/wide.py).

``replay(mk_or_k3, *tensors)`` is a context in which ``wide.gemm``,
``wide.gemm_f32`` and ``wide.rows_kernel`` run each kernel's arithmetic in
torch on the very buffers the wrapper hands the card: a device address is
resolved to the tensor that holds it among the tensors the test names and
those the wrapper passes itself, the tile and scratch layouts are read and
written as the CUDA source reads and writes them. So the wrapper's
orchestration (which product of which stream, which bias, which layout,
which epilogue, the chunks of a frame) runs here as it runs on the card,
and its result is held against the plain version. Sums are taken in
float64 (the card's order is its own). Imports no JAX: nothing here needs
it."""

import contextlib

import numpy as np
import torch

from adanerf_tpu_torch.ops import raymarch
from adanerf_tpu_torch.ops.kernels import megakernel_compact as mc
from adanerf_tpu_torch.ops.kernels import nerf_train as nt
from adanerf_tpu_torch.ops.kernels import wide
from adanerf_tpu_torch.realtime import unit, world_dirs


def bf(t):
    return t.to(torch.bfloat16).float()


def to_tiles(a):
    """(R, F) -> the tile layout (R a multiple of 64, F of 64), flat:
    element (r, k) of a 64-row tile at csrc/mlp_wgmma.cuh's sw128."""
    R, F = a.shape
    idx = torch.from_numpy(mc.swizzle128(64)).reshape(-1)
    blocks = a.reshape(R // 64, 64, F // 64, 64).permute(0, 2, 1, 3).reshape(-1, 4096)
    out = torch.empty_like(blocks)
    out[:, idx] = blocks
    return out.reshape(-1)


def from_tiles(flat, R, F):
    idx = torch.from_numpy(mc.swizzle128(64)).reshape(-1)
    blocks = flat[:R * F].reshape(-1, 4096)[:, idx]
    return blocks.reshape(R // 64, F // 64, 64, 64).permute(0, 2, 1, 3).reshape(R, F)


class _Memory:
    """Device addresses -> the tensors that hold them."""

    def __init__(self, tensors):
        self.tensors = [t for t in tensors if t is not None]

    def view(self, a):
        """The flat tensor from address (or tensor) a on."""
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            self.tensors.append(a)
            return a.reshape(-1) if a.is_contiguous() else a.view(-1)
        for t in self.tensors:
            base = t.data_ptr()
            if base <= a < base + t.numel() * t.element_size():
                assert (a - base) % t.element_size() == 0
                return t.view(-1)[(a - base) // t.element_size():]
        raise AssertionError(f"address {a:#x} is in no known tensor")


def _rows(mem, count, base, rows):
    if count is None:
        return rows
    return max(0, min(int(mem.view(count)[0]) - base, rows))


def _stream_matrix(flat, kc, n):
    """The (kc * 64, n) matrix of one product at the head of ``flat``, pass
    by pass (mc.passes), each pass's kc chunks."""
    out, off, f = [], 0, flat[:kc * 64 * n].float().numpy()
    for _, np_ in mc.passes(n):
        out.append(mc.unpack_chunks(f, off, kc * 64, np_))
        off += kc * 64 * np_
    return torch.from_numpy(np.concatenate(out, axis=1)).double()


class _Replay:
    def __init__(self, wrapper, tensors):
        self.w = wrapper
        self.mem = _Memory(tensors)
        self.gemms = []  # (n, rows) of each bf16 GEMM, for the tests to count

    def gemm(self, dev, a0, kc0, w, n, rows, a1=None, kc1=0, bias=None, relu=False, out=None,
             st=None, f32=None, ldf=0, f32_cols=0, f32_add=False, mask=None, bp=None, ldbp=0,
             ga=None, wa=None, count=None, base=0):
        v = self.mem.view
        M = _rows(self.mem, count, base, rows)
        self.gemms.append((n, rows))
        if M == 0:
            return
        R = wide.pad_rows(M)
        A = from_tiles(v(a0), R, kc0 * 64).double()
        if a1 is not None:
            A = torch.cat([A, from_tiles(v(a1), R, kc1 * 64).double()], 1)
        acc = A @ _stream_matrix(v(w), kc0 + kc1, n)
        if ga is not None:
            g = torch.zeros(R)
            g[:M] = bf(v(ga)[:4 * M].view(M, 4)[:, 3])
            acc += g.double()[:, None] * v(wa)[:n].double()[None, :]
        if bias is not None:
            acc += v(bias)[:n].double()
        if relu:
            acc = acc.clamp(min=0)
        if mask is not None:
            m = nt.untile_rows(v(mask), R // 64, n, R)
            acc[m.view(torch.int16) == 0] = 0.0
        acc = acc.float()
        if bp is not None:
            dst = v(bp)
            for bt in range(R // 128):
                dst[bt * ldbp:bt * ldbp + n] = acc[128 * bt:128 * (bt + 1)].double().sum(0).float()
        if f32 is not None:
            dst = v(f32)[:M * ldf].view(M, ldf)[:, :f32_cols]
            dst[:] = (dst if f32_add else 0) + acc[:M, :f32_cols]
        if out is not None:
            v(out)[:R * n] = to_tiles(acc.to(torch.bfloat16))
        if st is not None:
            v(st)[:R * n] = nt.tile_rows(acc.to(torch.bfloat16), R // 64)

    def gemm_f32(self, dev, a0, k0, w0, n, rows, bias, relu=False, out=None, a1=None, k1=0,
                 w1=None, count=None, base=0):
        v = self.mem.view
        M = _rows(self.mem, count, base, rows)
        if M == 0:
            return
        acc = v(a0)[:M * k0].view(M, k0).double() @ v(w0)[:k0 * n].view(k0, n).double()
        if a1 is not None:
            acc += v(a1)[:M * k1].view(M, k1).double() @ v(w1)[:k1 * n].view(k1, n).double()
        acc += v(bias)[:n].double()
        if relu:
            acc = acc.clamp(min=0)
        v(out)[:M * n] = acc.float().reshape(-1)

    def rows_kernel(self, name, dev, *args):
        getattr(self, "_" + name)(*args)

    # -- K3 ------------------------------------------------------------------

    def _load_x(self, x, N, n_in, xw, T, xt, st):
        X = torch.zeros(T * 64, xw)
        X[:N, :n_in] = self.mem.view(x)[:N * n_in].view(N, n_in)
        xb = X.to(torch.bfloat16)
        self.mem.view(xt)[:X.numel()] = to_tiles(xb)
        if st is not None:
            self.mem.view(st)[:X.numel()] = nt.tile_rows(xb, T)

    def _head(self, which, bf16, wbf16, h, F, w, b, alpha, ids, count, base, rows, out):
        v = self.mem.view
        M = _rows(self.mem, count, base, rows)
        if M == 0:
            return
        R = wide.pad_rows(M)
        H = (from_tiles(v(h), R, F) if bf16 else v(h)[:R * F].view(R, F))[:M].double()
        if which == 0:
            v(alpha)[:M] = (H @ v(w)[:F].double() + float(v(b)[0])).float()
            return
        o = H @ v(w)[:3 * F].view(F, 3).double() + v(b)[:3].double()
        j = torch.arange(base, base + M)
        idx = v(ids)[j].long() if ids is not None else j
        dst = v(out).view(-1, 4)
        dst[idx, :3] = o.float()
        dst[idx, 3] = v(alpha)[:M]

    def _gout(self, gout, N, T):
        g = torch.zeros(T * 64, 4, dtype=torch.float64)
        g[:N] = self.mem.view(gout)[:4 * N].view(N, 4).double()
        return g

    def _head_grads(self, h, hv, W, N, T, gout, bpart, ldbp, bp_wa, bp_wrgb, bp_rgb, bp_a):
        v = self.mem.view
        Hm = nt.untile_rows(v(h), T, W, T * 64).double()
        HV = nt.untile_rows(v(hv), T, W // 2, T * 64).double()
        g = self._gout(gout, N, T)
        gb = bf(g.float()).double()
        dst = v(bpart)
        for bt in range(T // 2):
            s = slice(128 * bt, 128 * (bt + 1))
            row = dst[bt * ldbp:(bt + 1) * ldbp]
            row[bp_wa:bp_wa + W] = (Hm[s] * gb[s, 3:4]).sum(0).float()
            row[bp_wrgb:bp_wrgb + 3 * W // 2] = (HV[s].T @ gb[s, :3]).reshape(-1).float()
            row[bp_rgb:bp_rgb + 3] = g[s, :3].sum(0).float()
            row[bp_a] = float(g[s, 3].sum())

    def _ghv(self, hv, st, V, N, T, gout, wrgb, bpart, ldbp, bp_v, gt):
        v = self.mem.view
        HV = nt.untile_rows(v(hv), T, V, T * 64)
        gb = bf(self._gout(gout, N, T).float()).double()
        val = gb[:, :3] @ v(wrgb)[:3 * V].view(V, 3).double().T
        val[HV.view(torch.int16) == 0] = 0.0
        val = val.float()
        dst = v(bpart)
        for bt in range(T // 2):
            dst[bt * ldbp + bp_v:bt * ldbp + bp_v + V] = \
                val[128 * bt:128 * (bt + 1)].double().sum(0).float()
        vb = val.to(torch.bfloat16)
        v(st)[:vb.numel()] = nt.tile_rows(vb, T)
        v(gt)[:vb.numel()] = to_tiles(vb)

    # -- K1 and K2 -------------------------------------------------------------

    def _put_x(self, x, rows, x_dst, width, bf16):
        """Encoded rows (n, <= width) padded with zeros to (rows, width)."""
        X = torch.zeros(rows, width)
        X[:x.shape[0], :x.shape[1]] = x
        if bf16:
            self.mem.view(x_dst)[:X.numel()] = to_tiles(X.to(torch.bfloat16))
        else:
            self.mem.view(x_dst)[:X.numel()] = X.reshape(-1)

    def _front_prep(self, P, dirs, pose, rot, o_sh, d_sh, x, R):
        rt, v = self.w.renderer, self.mem.view
        dirs, pose, rot = (v(t) for t in (dirs, pose, rot))
        B = P.B
        nds = world_dirs(dirs[:3 * B].view(B, 3), rot[:9].view(3, 3))
        origins = pose[:3].expand(nds.shape)
        dist = raymarch.ray_sphere_offset(nds, origins, rt.center, rt.scene.view_cell_radius)
        proj = origins + nds * dist[:, None]
        self._put_x(torch.cat([rt.enc0_dir(nds), rt.enc0_pos(proj)], -1), R, x, P.in0, P.bf16)
        if rt.use_ndc:
            sc = rt.scene
            os_, ds_ = raymarch.ndc_rays(sc.h, sc.w, sc.focal, 1.0, origins, nds)
        else:
            os_, ds_ = proj, nds
        v(o_sh)[:3 * B] = os_.reshape(-1)
        v(d_sh)[:3 * B] = ds_.reshape(-1)

    def _select(self, P, dense, logits, zbuf, pbuf, counts, rows, counter):
        rt, v = self.w.renderer, self.mem.view
        from adanerf_tpu_torch.ops.samplers import adaptive_select
        B, S, D = P.B, P.S, P.D
        lg = v(logits)[:128 * B].view(B, 128)[:, :D]
        z_unit, z_probs, mask = adaptive_select(lg, S, rt.threshold)
        z = rt._to_world(z_unit)
        n = mask.sum(1)
        zb, pb = torch.zeros(B, S), torch.zeros(B, S)
        dead_z = float(rt._to_world(torch.tensor([0.5 / D]))[0]) if dense else 0.0
        for r in range(B):  # the live slots first, in ascending bin order
            live = torch.nonzero(mask[r]).reshape(-1)
            order = live[torch.argsort(z_unit[r, live])]
            zb[r, :len(order)], pb[r, :len(order)] = z[r, order], z_probs[r, order]
            zb[r, len(order):] = dead_z
        v(zbuf)[:B * S] = zb.reshape(-1)
        v(pbuf)[:B * S] = pb.reshape(-1)
        v(counts)[:B] = n.int()
        if not dense:
            ids = torch.cat([r * S + torch.arange(int(n[r])) for r in range(B)])
            v(rows)[:ids.numel()] = ids.int()
            v(counter)[0] = ids.numel()

    def _shade_prep(self, P, dense, o_sh, d_sh, zbuf, ids, counter, base, rows, x):
        rt, v = self.w.renderer, self.mem.view
        total = P.B * P.S if dense else int(v(counter)[0])
        m = max(0, min(rows, total - base))
        j = torch.arange(base, base + m)
        idx = j if dense else v(ids)[j].long()
        r = idx // P.S
        o, d = v(o_sh)[:3 * P.B].view(-1, 3)[r], v(d_sh)[:3 * P.B].view(-1, 3)[r]
        pos = o + d * v(zbuf)[idx][:, None]
        enc = rt._encode_samples(pos, unit(d) if rt.use_ndc else d)
        self._put_x(enc, rows, x, P.in1, P.bf16)

    def _composite(self, P, dense, raw, pbuf, counts, rgb):
        rt, v = self.w.renderer, self.mem.view
        B, S = P.B, P.S
        live = (torch.arange(S)[None, :] < v(counts)[:B].long()[:, None]).float()
        restored = torch.sigmoid(v(raw)[:4 * B * S].view(B, S, 4)) * live[..., None]
        restored = torch.nan_to_num(restored)  # K1 leaves the dead slots' raw unwritten
        v(rgb)[:3 * B] = rt._composite(restored, v(pbuf)[:B * S].view(B, S)).reshape(-1)


@contextlib.contextmanager
def replay(wrapper, *tensors):
    """wide.gemm / gemm_f32 / rows_kernel replayed on the CPU for the
    wrapper's calls; ``tensors``: the buffers the test hands the wrapper
    (their addresses may reach the kernels as ints). Yields the replay."""
    r = _Replay(wrapper, tensors)
    saved = wide.gemm, wide.gemm_f32, wide.rows_kernel
    wide.gemm, wide.gemm_f32, wide.rows_kernel = r.gemm, r.gemm_f32, r.rows_kernel
    try:
        yield r
    finally:
        wide.gemm, wide.gemm_f32, wide.rows_kernel = saved


def k1_wide_on_cpu(mk, dirs, pose, rot, stages=3):
    """K1's (or K2's) wide path on CPU tensors through the replay: the
    wrapper's own orchestration, ``front_wide`` and ``shade_wide``
    regardless of its widths. Returns (rgb, counts)."""
    P = mc.MkParams.from_buffer_copy(mk.params)
    B, S = dirs.shape[0], P.S
    P.B = B
    pose = torch.as_tensor(pose, dtype=torch.float32).reshape(3)
    rot = torch.as_tensor(rot, dtype=torch.float32).reshape(3, 3)
    o_sh, d_sh = torch.zeros(B, 3), torch.zeros(B, 3)
    zbuf, pbuf = torch.zeros(B, S), torch.zeros(B, S)
    counts = torch.zeros(B, dtype=torch.int32)
    rows = counter = None
    if not mk.DENSE:
        rows, counter = torch.zeros(B * S, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    raw, rgb = torch.full((B, S, 4), float("nan")), torch.zeros(B, 3)
    bufs = (o_sh, d_sh, zbuf, pbuf, counts, rows, counter, raw, rgb)
    with replay(mk, mk.weights, mk.biases, dirs, pose, rot, *bufs):
        mk._front_wide(P, dirs, pose, rot, bufs)
        mk._shade_wide(P, torch.device("cpu"), bufs, stages)
    return rgb, counts


def k3_forward_on_cpu(k3, x):
    """K3's forward on the wide path, on CPU tensors through the replay."""
    packed = k3.pack(dict(k3.nerf.named_parameters()), "cpu")
    out = torch.zeros(x.shape[0], 4)
    with replay(k3, *packed, x, out):
        k3._forward_wide(x, packed, out)
    return out


def k3_backward_on_cpu(k3, x, g, scratch=None):
    """K3's backward on the wide path, on CPU tensors through the replay:
    (dx, {leaf: grad}) as backward_kernel gives them on the card, the
    scratch (``new_scratch(N)``, or one of the replay's own) filled as the
    card fills it. The weight-gradient kernels (k3_dw, k3_reduce) are the
    fused path's: the table over the scratch, the bias partials summed over
    the 128-row tiles."""
    packed = k3.pack(dict(k3.nerf.named_parameters()), "cpu")
    N, T = x.shape[0], k3.tiles(x.shape[0])
    if scratch is None:
        scratch = k3.new_scratch(N, "cpu")
    bpart = torch.zeros(T // 2, k3.params.bp_width)
    dx = torch.zeros(N, k3.n_in)
    with replay(k3, *packed, scratch, bpart, dx, x, g):
        k3._chain_wide(x, g, packed, scratch, bpart, dx)
    gbuf = torch.zeros(k3.grad_size, dtype=torch.float64)
    gbuf[:k3.params.bp_width] = bpart.double().sum(0)
    t = torch.arange(T)
    for d in k3.dw_tiles(N):
        idx_b = torch.from_numpy(mc.swizzle128(d.n)).reshape(-1)
        B = scratch[d.b + t[:, None] * d.b_stride + idx_b[None, :]].view(T, d.n, 64)
        for s in range(d.nslab):
            idx_a = torch.from_numpy(mc.swizzle128(64)).reshape(-1)
            A = scratch[d.a + t[:, None] * d.a_stride + s * 4096 + idx_a[None, :]].view(T, 64, 64)
            part = torch.einsum("tfr,tmr->fm", A.double(), B.double())
            k = d.k0 + 64 * s + torch.arange(64)
            r = torch.nonzero((k >= d.k_lo) & (k < d.k_hi)).flatten()
            at = (d.dst + (k[r] - d.k_lo) * d.ldo)[:, None] + torch.arange(d.m_valid)[None, :]
            gbuf[at.flatten()] = part[r, :d.m_valid].flatten()
    return dx, k3.grads_from(gbuf.float())


class _WideFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k3, *leaves):
        ctx.k3 = k3
        ctx.save_for_backward(x)
        return k3_forward_on_cpu(k3, x.detach())

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dx, grads = k3_backward_on_cpu(ctx.k3, x.detach(), g.contiguous())
        return (dx, None, *[grads[n] for n in ctx.k3.names])


class WideStandIn:
    """K3's interface as ``nerf_train_check.compare`` uses it, its kernel
    side the wide path replayed on the CPU: the card's check of K3 against
    its plain version, run here on the wide path's launch sequence."""

    forward_launches = backward_launches = 0

    def __init__(self, k3):
        self.k3, self.nerf, self.n_in = k3, k3.nerf, k3.n_in
        for name in ("plain", "pack", "new_scratch", "relu_outputs", "scratch_matrix"):
            setattr(self, name, getattr(k3, name))

    def __call__(self, x):
        leaves = [p for _, p in self.nerf.named_parameters()]
        return _WideFn.apply(x.contiguous(), self.k3, *leaves)

    def backward_kernel(self, x, g, packed, scratch=None):
        return k3_backward_on_cpu(self.k3, x, g.contiguous(), scratch)
