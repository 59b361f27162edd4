"""K3: the NeRF shading MLP's fused forward and backward for the train step,
as hand-written CUDA (``csrc/nerf_train.cu``) beside its plain PyTorch
version.

Replaces ``adanerf_tpu/ops/pallas/train_kernel.py::make_nerf_train_apply``.
``NerfTrainKernel(nerf)`` is a drop-in for ``nerf(x, dtype=torch.bfloat16)``
inside the train step: calling it on encoded inputs ``x (..., 63+27)``
returns ``[rgb, alpha] (..., 4)``, and autograd reaches every NeRF leaf and
``x`` through it.

  * on a CUDA tensor it runs the ``torch.autograd.Function`` whose forward
    launches ``k3_forward`` and whose backward launches ``k3_backward``
    (the recomputing chain kernel, the split-K weight gradients and the
    bias sums); each launch adds one to ``forward_launches`` or
    ``backward_launches``;
  * on a CPU tensor it runs the plain version, ``plain``: the module's own
    bf16 forward (bf16 operands, fp32 accumulation) under autograd.

The kernel's arithmetic is the TPU kernel's: each product rounds both
operands to bf16 and sums in fp32, in the weight gradients too; biases and
bias gradients are fp32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Tuple

import torch

from . import build

SOURCE = "nerf_train.cu"
MAXL = 16    # most trunk layers (K3Params arrays)
WIDTH = 256  # hidden width the kernel is written for
XS = 128     # widest encoded input (columns of the kernel's input tile)
ALIGN = 64   # element alignment of each packed matrix
ROWS_PER_SPLIT = 4096  # rows per fp32 partial of a weight gradient
ROADMAP = "other NeRF shapes: ROADMAP Queue 2, K3"

_ll = ctypes.c_longlong * MAXL


class K3Params(ctypes.Structure):
    """Mirror of ``struct K3Params`` in the CUDA source, field for field."""
    _fields_ = [(k, _ll) for k in ("w", "wx", "wT", "wxT", "b")] + \
        [(k, ctypes.c_longlong) for k in ("wf", "wa", "wvf", "wvd", "wrgb", "wfT", "waT",
                                          "wvfT", "wvdT", "wrgbT", "bf", "ba", "bv", "brgb",
                                          "zero")] + \
        [("s_h", _ll), ("s_g", _ll)] + \
        [(k, ctypes.c_longlong) for k in ("s_feat", "s_hv", "s_gfeat", "s_ghv")] + \
        [("bp", _ll)] + \
        [(k, ctypes.c_longlong) for k in ("bp_f", "bp_a", "bp_v", "bp_rgb", "bp_width")] + \
        [(k, ctypes.c_int) for k in ("N", "n_in", "in_ch", "in_pad", "depth", "skip_mask")]


class DwJob(ctypes.Structure):
    """Mirror of ``struct DwJob``: one weight gradient out = A^T G."""
    _fields_ = [("a", ctypes.c_void_p), ("g", ctypes.c_void_p), ("out", ctypes.c_void_p)] + \
        [(k, ctypes.c_int) for k in ("a_f32", "g_f32", "lda", "a_col", "ldg", "g_col", "K",
                                     "M", "ldo", "N", "splits", "rows_per_split")]


class _Layout:
    """Offsets of packed matrices in a flat buffer; each entry records how to
    fill its block from a parameter: (offset, rows, cols, name, row slice,
    transposed, destination row/column start)."""

    def __init__(self):
        self.size = 0
        self.fills: List[Tuple] = []

    def block(self, rows: int, cols: int) -> int:
        off = self.size
        self.size += ALIGN * math.ceil(rows * cols / ALIGN)
        return off

    def add(self, rows, cols, name, src_rows=None, transpose=False, at=(0, 0)) -> int:
        off = self.block(rows, cols)
        self.fills.append((off, rows, cols, name, src_rows, transpose, at))
        return off

    def pack(self, params: Dict[str, torch.Tensor], dtype, device) -> torch.Tensor:
        buf = torch.zeros(self.size, dtype=dtype, device=device)
        for off, rows, cols, name, src_rows, transpose, (r0, c0) in self.fills:
            src = params[name].detach()
            if src.ndim == 1:
                src = src[None, :]
            if src_rows is not None:
                src = src[src_rows[0]:src_rows[1]]
            if transpose:
                src = src.t()
            dst = buf[off:off + rows * cols].view(rows, cols)
            dst[r0:r0 + src.shape[0], c0:c0 + src.shape[1]] = src.to(dtype)
        return buf


class NerfTrainKernel:
    """K3 wrapper around a ``NeRFDef`` (whose bf16 forward is the plain
    version). Counts launches over all instances in ``forward_launches``
    and ``backward_launches``."""

    forward_launches = 0
    backward_launches = 0

    def __init__(self, nerf):
        if nerf.width != WIDTH:
            raise ValueError(f"kernel needs NeRF width {WIDTH}, got {nerf.width} ({ROADMAP})")
        if nerf.depth > MAXL or nerf.depth < 1:
            raise ValueError(f"kernel needs 1..{MAXL} trunk layers, got {nerf.depth} ({ROADMAP})")
        n_in = nerf.input_ch + nerf.input_ch_views
        in_pad = 32 * math.ceil(n_in / 32)
        if in_pad > XS:
            raise ValueError(f"kernel takes at most {XS} input columns, got {n_in} ({ROADMAP})")
        self.nerf = nerf
        self.n_in, self.in_pad = n_in, in_pad
        W, H, ic, iv, D = WIDTH, WIDTH // 2, nerf.input_ch, nerf.input_ch_views, nerf.depth

        P = K3Params()
        wl, bl = _Layout(), _Layout()
        P.w[0] = wl.add(in_pad, W, "pts.0.w")
        P.wT[0] = wl.add(W, XS, "pts.0.w", transpose=True)
        skip_mask = 0
        for i in range(1, D):
            name = f"pts.{i}.w"
            if (i - 1) in nerf.skips:  # the layer takes [input_pts, h]
                skip_mask |= 1 << (i - 1)
                P.wx[i] = wl.add(in_pad, W, name, src_rows=(0, ic))
                P.wxT[i] = wl.add(W, XS, name, src_rows=(0, ic), transpose=True)
                P.w[i] = wl.add(W, W, name, src_rows=(ic, ic + W))
                P.wT[i] = wl.add(W, W, name, src_rows=(ic, ic + W), transpose=True)
            else:
                P.w[i] = wl.add(W, W, name)
                P.wT[i] = wl.add(W, W, name, transpose=True)
        P.wf = wl.add(W, W, "feature.w")
        P.wfT = wl.add(W, W, "feature.w", transpose=True)
        P.wa = wl.add(1, W, "alpha.w", transpose=True)
        P.waT = wl.add(32, W, "alpha.w", transpose=True)
        P.wvf = wl.add(W, H, "views.0.w", src_rows=(0, W))
        P.wvfT = wl.add(H, W, "views.0.w", src_rows=(0, W), transpose=True)
        P.wvd = wl.add(in_pad, H, "views.0.w", src_rows=(W, W + iv), at=(ic, 0))
        P.wvdT = wl.add(H, XS, "views.0.w", src_rows=(W, W + iv), transpose=True, at=(0, ic))
        P.wrgb = wl.add(H, 3, "rgb.w")
        P.wrgbT = wl.add(32, H, "rgb.w", transpose=True)
        for i in range(D):
            P.b[i] = bl.add(1, W, f"pts.{i}.b")
        P.bf, P.ba = bl.add(1, W, "feature.b"), bl.add(1, 1, "alpha.b")
        P.bv, P.brgb = bl.add(1, H, "views.0.b"), bl.add(1, 3, "rgb.b")
        P.zero = bl.block(1, W)
        # bias-partial columns: trunk layers, feature, views, rgb, alpha
        for i in range(D):
            P.bp[i] = i * W
        P.bp_f, P.bp_v = D * W, D * W + W
        P.bp_rgb = P.bp_v + H
        P.bp_a = P.bp_rgb + 3
        P.bp_width = 4 * math.ceil((P.bp_a + 1) / 4)
        P.n_in, P.in_ch, P.in_pad, P.depth, P.skip_mask = n_in, ic, in_pad, D, skip_mask
        self.params, self.w_layout, self.b_layout = P, wl, bl
        self.bias_slices = {f"pts.{i}.b": (P.bp[i], W) for i in range(D)}
        self.bias_slices.update({"feature.b": (P.bp_f, W), "views.0.b": (P.bp_v, H),
                                 "rgb.b": (P.bp_rgb, 3), "alpha.b": (P.bp_a, 1)})

    # -- the plain version ---------------------------------------------------

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The module's bf16 forward: bf16 operands, fp32 accumulation."""
        return self.nerf(x, dtype=torch.bfloat16)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        names = [n for n, _ in self.nerf.named_parameters()]
        leaves = [p for _, p in self.nerf.named_parameters()]
        lead = x.shape[:-1]
        out = _K3Function.apply(x.reshape(-1, x.shape[-1]), self, names, *leaves)
        return out.reshape(*lead, 4)

    # -- launches ------------------------------------------------------------

    def pack(self, named: Dict[str, torch.Tensor], device):
        """bf16 weight buffer (forward and transposed blocks) and fp32 bias
        buffer, rebuilt from the current parameters."""
        return (self.w_layout.pack(named, torch.bfloat16, device),
                self.b_layout.pack(named, torch.float32, device))

    def _check(self, x: torch.Tensor):
        if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != self.n_in \
                or not x.is_contiguous():
            raise ValueError(f"x must be a contiguous (N, {self.n_in}) float32 tensor")

    def _base(self, N: int) -> K3Params:
        P = K3Params.from_buffer_copy(self.params)
        P.N = N
        W, D = WIDTH, self.nerf.depth
        NW = N * W
        for i in range(D):
            P.s_h[i] = i * NW
        P.s_feat = D * NW
        P.s_hv = P.s_feat + NW
        for i in range(D):
            P.s_g[i] = P.s_hv + N * (W // 2) + i * NW
        P.s_gfeat = P.s_g[0] + D * NW
        P.s_ghv = P.s_gfeat + NW
        return P

    def new_scratch(self, N: int, device) -> torch.Tensor:
        """The backward's bf16 scratch for N rows."""
        return torch.empty(self._base(N).s_ghv + N * (WIDTH // 2), dtype=torch.bfloat16,
                           device=device)

    def relu_outputs(self, scratch: torch.Tensor, N: int) -> List[torch.Tensor]:
        """Views of a used scratch: each trunk layer's bf16 relu output
        (N, 256), then the views layer's (N, 128)."""
        P = self._base(N)
        W = WIDTH
        return [scratch[P.s_h[i]:P.s_h[i] + N * W].view(N, W) for i in range(self.nerf.depth)] \
            + [scratch[P.s_hv:P.s_hv + N * (W // 2)].view(N, W // 2)]

    def forward_kernel(self, x: torch.Tensor, wts, bias) -> torch.Tensor:
        self._check(x)
        N = x.shape[0]
        out = torch.empty((N, 4), dtype=torch.float32, device=x.device)
        P = self._base(N)
        rc = _library().k3_forward(_device_index(x), ctypes.byref(P), x.data_ptr(),
                                   wts.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                   torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nerf_train forward launch failed: CUDA error {rc}")
        NerfTrainKernel.forward_launches += 1
        return out

    def backward_kernel(self, x, g, wts, bias, names_shapes, scratch=None):
        """Returns (dx (N, n_in), {leaf name: fp32 grad}). ``scratch``, from
        ``new_scratch(N)``, lets the caller read the recomputed bf16 relu
        outputs afterwards (``relu_outputs``)."""
        self._check(x)
        g = g.to(torch.float32).contiguous()
        N, dev = x.shape[0], x.device
        W, H, D, ic, iv = WIDTH, WIDTH // 2, self.nerf.depth, self.nerf.input_ch, \
            self.nerf.input_ch_views
        P = self._base(N)
        if scratch is None:
            scratch = self.new_scratch(N, dev)
        tiles = math.ceil(N / 64)
        bpart = torch.empty((tiles, P.bp_width), dtype=torch.float32, device=dev)
        dx = torch.empty((N, self.n_in), dtype=torch.float32, device=dev)
        bias_grad = torch.empty(P.bp_width, dtype=torch.float32, device=dev)
        grads = {n: torch.empty(s, dtype=torch.float32, device=dev)
                 for n, s in names_shapes if n.endswith(".w")}
        sp = scratch.data_ptr()
        bf = scratch.element_size()
        splits = math.ceil(N / ROWS_PER_SPLIT)

        def job(a, a_f32, lda, a_col, gp, g_f32, ldg, g_col, K, M, out, row0=0):
            j = DwJob()
            j.a, j.g = a, gp
            j.out = out.data_ptr() + row0 * out.shape[1] * out.element_size()
            j.a_f32, j.g_f32, j.lda, j.a_col, j.ldg, j.g_col = a_f32, g_f32, lda, a_col, ldg, g_col
            j.K, j.M, j.ldo, j.N = K, M, out.shape[1], N
            j.splits, j.rows_per_split = splits, ROWS_PER_SPLIT
            return j

        xp, gp = x.data_ptr(), g.data_ptr()
        s_h = [sp + P.s_h[i] * bf for i in range(D)]
        s_g = [sp + P.s_g[i] * bf for i in range(D)]
        jobs = [job(xp, 1, self.n_in, 0, s_g[0], 0, W, 0, ic, W, grads["pts.0.w"])]
        for i in range(1, D):
            out = grads[f"pts.{i}.w"]
            if (i - 1) in self.nerf.skips:
                jobs.append(job(xp, 1, self.n_in, 0, s_g[i], 0, W, 0, ic, W, out))
                jobs.append(job(s_h[i - 1], 0, W, 0, s_g[i], 0, W, 0, W, W, out, row0=ic))
            else:
                jobs.append(job(s_h[i - 1], 0, W, 0, s_g[i], 0, W, 0, W, W, out))
        jobs.append(job(s_h[D - 1], 0, W, 0, sp + P.s_gfeat * bf, 0, W, 0, W, W,
                        grads["feature.w"]))
        jobs.append(job(s_h[D - 1], 0, W, 0, gp, 1, 4, 3, W, 1, grads["alpha.w"]))
        jobs.append(job(sp + P.s_feat * bf, 0, W, 0, sp + P.s_ghv * bf, 0, H, 0, W, H,
                        grads["views.0.w"]))
        jobs.append(job(xp, 1, self.n_in, ic, sp + P.s_ghv * bf, 0, H, 0, iv, H,
                        grads["views.0.w"], row0=W))
        jobs.append(job(sp + P.s_hv * bf, 0, H, 0, gp, 1, 4, 0, H, 3, grads["rgb.w"]))
        part = torch.empty(max(j.splits * j.K * j.M for j in jobs), dtype=torch.float32,
                           device=dev)
        jobs_arr = (DwJob * len(jobs))(*jobs)
        rc = _library().k3_backward(_device_index(x), ctypes.byref(P), xp, gp, wts.data_ptr(),
                                    bias.data_ptr(), sp, bpart.data_ptr(), dx.data_ptr(),
                                    jobs_arr, len(jobs), part.data_ptr(), bias_grad.data_ptr(),
                                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nerf_train backward launch failed: CUDA error {rc}")
        NerfTrainKernel.backward_launches += 1
        for name, (col, width) in self.bias_slices.items():
            grads[name] = bias_grad[col:col + width]
        return dx, grads


class _K3Function(torch.autograd.Function):
    """out = K3(x; NeRF leaves); the backward is the kernel's backward and
    returns fp32 grads for x and every leaf, like the TPU kernel's
    custom_vjp."""

    @staticmethod
    def forward(ctx, x, kernel, names, *leaves):
        x = x.to(torch.float32).contiguous()
        named = dict(zip(names, leaves))
        wts, bias = kernel.pack(named, x.device)
        ctx.kernel, ctx.names = kernel, names
        ctx.shapes = [tuple(p.shape) for p in leaves]
        ctx.save_for_backward(x, wts, bias)
        return kernel.forward_kernel(x, wts, bias)

    @staticmethod
    def backward(ctx, g):
        x, wts, bias = ctx.saved_tensors
        dx, grads = ctx.kernel.backward_kernel(x, g, wts, bias,
                                               list(zip(ctx.names, ctx.shapes)))
        return (dx if ctx.needs_input_grad[0] else None, None, None,
                *[grads[n].reshape(s) for n, s in zip(ctx.names, ctx.shapes)])


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _library():
    lib = build.load(SOURCE)
    if not getattr(lib, "_k3_bound", False):
        lib.k3_forward.argtypes = [ctypes.c_int, ctypes.POINTER(K3Params)] + [ctypes.c_void_p] * 5
        lib.k3_forward.restype = ctypes.c_int
        lib.k3_backward.argtypes = [ctypes.c_int, ctypes.POINTER(K3Params)] + \
            [ctypes.c_void_p] * 7 + [ctypes.POINTER(DwJob), ctypes.c_int] + [ctypes.c_void_p] * 3
        lib.k3_backward.restype = ctypes.c_int
        lib.k3_struct_size.argtypes = [ctypes.c_int]
        lib.k3_struct_size.restype = ctypes.c_int
        for which, cls in ((0, K3Params), (1, DwJob)):
            if lib.k3_struct_size(which) != ctypes.sizeof(cls):
                raise RuntimeError(f"{cls.__name__} layout differs: C {lib.k3_struct_size(which)} "
                                   f"bytes, ctypes {ctypes.sizeof(cls)} bytes")
        lib._k3_bound = True
    return lib
