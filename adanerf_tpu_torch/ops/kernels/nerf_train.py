"""K3: the NeRF shading MLP's fused forward and backward for the train step,
as hand-written CUDA (``csrc/nerf_train.cu``) on Hopper's tensor cores,
beside its plain PyTorch version.

Replaces ``adanerf_tpu/ops/pallas/train_kernel.py::make_nerf_train_apply``.
``NerfTrainKernel(nerf)`` is a drop-in for ``nerf(x, dtype=torch.bfloat16)``
inside the train step: calling it on encoded inputs ``x (..., n_in)``
returns ``[rgb, alpha] (..., 4)``, and autograd reaches every NeRF leaf and
``x`` through it.

  * on a CUDA tensor it runs the ``torch.autograd.Function`` whose forward
    launches ``k3_forward`` and whose backward launches ``k3_backward`` (the
    recompute, the chain, one launch of the weight-gradient GEMMs and one
    fixed-order reduce: BACKWARD_KERNELS launches); each call adds one to
    ``forward_launches`` or ``backward_launches``, and the forward keeps
    its row count in ``forward_rows``;
  * on a CPU tensor it runs the plain version, ``plain``: the module's own
    bf16 forward (bf16 operands, fp32 accumulation) under autograd.

The kernel's arithmetic is the TPU kernel's: each product rounds both
operands to bf16 and sums in fp32, in the weight gradients too; biases and
bias gradients are fp32. It takes every NeRF the JAX package routes to its
TPU kernel (adanerf_tpu/train_state.py:313-314: a width that is a multiple
of 128), of any depth and any number of encoded input columns. Widths 128
and 256 with at most 128 input columns run the fused kernels (``WIDTHS``;
one library each, ``library``); a wider NeRF (384 and up, where the wide
path measured faster than the fused kernels) or one with more input
columns takes the wide path (``csrc/wide.cu``, ``wide.py``): its
layers one at a time as GEMMs with fused epilogues, the activations in
device memory, ending in the same weight-gradient GEMMs (``self.wide``).

Layouts the card reads, built here (the CPU tests hold them):
  * two weight streams (``stream_plan``): every matrix the forward and the
    backward chain multiply by, in the order the kernels walk them, as
    64-row chunks transposed and swizzled (``megakernel_compact.swizzle128``)
    so that each arrives by one bulk copy. They are gathered on the device
    from the current parameters at every step (``pack``);
  * the backward's bf16 scratch (``tile_rows``): each matrix of N rows and
    F features, per 64-row tile, as F x 64 swizzled blocks, the layout in
    which the weight-gradient GEMMs read both operands;
  * the weight-gradient table (``dw_tiles``): which scratch matrices make
    which rows of which gradient.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import build, wide
from .megakernel_compact import PASS, TC_KC, passes, swizzle128, unpack_chunks

SOURCE = "nerf_train.cu"
WIDTHS = (128, 256)  # hidden widths of the fused libraries, one each
XW = 128     # encoded input columns of the fused kernels, padded (the wide path: 64-multiples)
FUSED_DEPTH = 65  # the fused kernels' most trunk layers (K3Params::skip_bits)
TILE_ROWS = 64   # rows of a scratch tile (the wgmma M)
DW_SLICE_TILES = 256  # row tiles per weight-gradient partial (16,384 rows)
DW_PART = 2 * TILE_ROWS * PASS  # floats of one partial slot
BACKWARD_KERNEL_NAMES = ("k3_recompute", "k3_chain", "k3_dw", "k3_reduce")  # launch order
BACKWARD_KERNELS = len(BACKWARD_KERNEL_NAMES)


def libraries(width: int, n_in: int, depth: int) -> List[str]:
    """The libraries (``build`` names) a NeRF of this shape runs on: its
    fused library, or the wide path's and the library whose weight-gradient
    kernels end it."""
    if width in WIDTHS and n_in <= XW and depth <= FUSED_DEPTH:
        return [library(width)]
    return [wide.SOURCE, library(WIDTHS[1])]


def library(width: int) -> str:
    """The library (``build`` name) of K3 at a hidden width: the source as
    it is at 256, its ``K3_WIDTH`` variant at the others."""
    return SOURCE if width == 256 else build.variant(SOURCE, "K3_WIDTH", width)


class K3Params(ctypes.Structure):
    """Mirror of ``struct K3Params`` in the CUDA source, field for field."""
    _fields_ = [("skip_bits", ctypes.c_ulonglong)] + \
        [(k, ctypes.c_longlong) for k in ("bf", "ba", "bv", "brgb", "wa", "wrgb", "s_x", "s_h",
                                          "s_g", "s_step", "s_feat", "s_hv", "s_gfeat", "s_ghv",
                                          "bp_f", "bp_v", "bp_rgb", "bp_a", "bp_wa", "bp_wrgb",
                                          "bp_width")] + \
        [(k, ctypes.c_int) for k in ("N", "n_in", "depth", "tiles", "blocks")]


class DwTile(ctypes.Structure):
    """Mirror of ``struct DwTile``: one output tile of the weight-gradient
    GEMMs."""
    _fields_ = [(k, ctypes.c_longlong) for k in ("a", "b", "dst")] + \
        [(k, ctypes.c_int) for k in ("a_stride", "b_stride", "n", "nslab", "k0", "k_lo", "k_hi",
                                     "ldo", "m_valid", "pad")]


def stream_plan(depth: int, skips, width: int = 256, xw: int = XW
                ) -> Tuple[List[Tuple[str, int, int]], List[Tuple[str, int, int]]]:
    """(forward, backward): [(what, K, N)] for each matrix B of the products
    ``A (64 x K) @ B (K x N)`` that the kernels walk, in the walk order of
    ``csrc/nerf_train.cu::k3_produce`` (and of the wide path's GEMMs, one
    product each). x is padded to xw columns. A product wider than 256
    columns comes pass by pass (``passes``): pass c0's columns of each of
    its matrices, named ``what@c0``."""
    W, H, X = width, width // 2, xw

    def layer(n, *mats):  # mats: (what, K) of the product's inputs
        if n <= PASS:
            return [(what, K, n) for what, K in mats]
        return [(f"{what}@{c0}", K, np_) for c0, np_ in passes(n) for what, K in mats]
    fwd = layer(W, ("pts.0", X))
    for i in range(1, depth):
        fwd += layer(W, (f"pts.{i}", W), *([(f"pts.{i}.x", X)] if (i - 1) in skips else []))
    fwd += layer(W, ("feature", W)) + layer(H, ("views.f", W), ("views.x", X))
    bwd = layer(X, ("views.x^T", H)) + layer(W, ("views.f^T", H)) + layer(W, ("feature^T", W))
    for i in range(depth - 1, 0, -1):
        if (i - 1) in skips:
            bwd += layer(X, (f"pts.{i}.x^T", W))
        bwd += layer(W, (f"pts.{i}^T", W))
    bwd += layer(X, ("pts.0^T", W))
    return fwd, bwd


def unpack_stream(flat: np.ndarray, plan) -> Dict[str, np.ndarray]:
    """{what: (K, N) matrix} of a weight stream walked by its plan, as the
    kernels read it: a matrix streamed in passes has its passes' columns
    put back side by side."""
    out, off = {}, 0
    for what, K, N in plan:
        name, _, c0 = what.partition("@")
        m = unpack_chunks(flat, off, K, N)
        out[name] = np.concatenate([out[name], m], axis=1) if c0 not in ("", "0") else m
        off += K * N
    assert off == flat.size, (off, flat.size)
    return out


def chunk_order(a: np.ndarray, fill) -> np.ndarray:
    """A (K, N) matrix (K a multiple of 64) as stream chunks: each 64-row
    block transposed to (N, 64) and laid out by ``swizzle128``, one after
    the other; ``fill`` where nothing lands (nowhere, for a full matrix)."""
    K, n = a.shape
    idx = swizzle128(n)
    out = np.full((K // TC_KC, n * TC_KC), fill, dtype=a.dtype)
    for c in range(K // TC_KC):
        out[c, idx] = a[c * TC_KC:(c + 1) * TC_KC].T
    return out.reshape(-1)


def tile_rows(a: torch.Tensor, tiles: int) -> torch.Tensor:
    """(N, F) -> flat (tiles * 64 * F): the scratch layout of a matrix.
    Rows padded with zeros to tiles * 64; per 64-row tile the (F, 64)
    transpose laid out by ``swizzle128(F)``."""
    N, F = a.shape
    full = torch.zeros((tiles * TILE_ROWS, F), dtype=a.dtype, device=a.device)
    full[:N] = a
    blocks = full.view(tiles, TILE_ROWS, F).transpose(1, 2)  # (tiles, F, 64)
    out = torch.empty((tiles, F * TILE_ROWS), dtype=a.dtype, device=a.device)
    idx = torch.from_numpy(swizzle128(F)).to(a.device).reshape(-1)
    out[:, idx] = blocks.reshape(tiles, -1)
    return out.reshape(-1)


def untile_rows(flat: torch.Tensor, tiles: int, F: int, N: int) -> torch.Tensor:
    """The (N, F) matrix that ``tile_rows`` (or the chain kernel) wrote to
    ``flat`` (a scratch matrix region)."""
    idx = torch.from_numpy(swizzle128(F)).to(flat.device).reshape(-1)
    blocks = flat[:tiles * F * TILE_ROWS].view(tiles, F * TILE_ROWS)[:, idx]
    return blocks.view(tiles, F, TILE_ROWS).transpose(1, 2).reshape(-1, F)[:N]


def _pad(a: np.ndarray, rows: int, cols: int, fill, at=(0, 0)) -> np.ndarray:
    out = np.full((rows, cols), fill, dtype=a.dtype)
    out[at[0]:at[0] + a.shape[0], at[1]:at[1] + a.shape[1]] = a
    return out


class NerfTrainKernel:
    """K3 wrapper around a ``NeRFDef`` (whose bf16 forward is the plain
    version). Counts calls over all instances in ``forward_launches`` and
    ``backward_launches``; ``forward_rows`` is the row count of the last
    forward launch."""

    forward_launches = 0
    backward_launches = 0
    forward_rows = None

    def __init__(self, nerf):
        if nerf.width % 128 or nerf.width < 128:
            raise ValueError(f"kernel needs a NeRF width that is a multiple of 128, got "
                             f"{nerf.width} (the JAX package routes no other to its kernel: "
                             "train_state.py:313-314)")
        if nerf.depth < 1:
            raise ValueError(f"kernel needs at least one trunk layer, got {nerf.depth}")
        n_in = nerf.input_ch + nerf.input_ch_views
        self.nerf = nerf
        self.n_in = n_in
        self.width = W = nerf.width
        # the fused kernels hold a tile's activations and its 128-column x on chip
        self.wide = W not in WIDTHS or n_in > XW or nerf.depth > FUSED_DEPTH
        self.xw = TC_KC * math.ceil(n_in / TC_KC) if self.wide else XW
        H, ic, iv, D, X = W // 2, nerf.input_ch, nerf.input_ch_views, nerf.depth, self.xw
        self.names = [n for n, _ in nerf.named_parameters()]
        self.shapes = {n: tuple(p.shape) for n, p in nerf.named_parameters()}

        # every packed buffer is a gather from the flat parameter vector
        # (named_parameters order) followed by one zero at index Z
        offs, total = {}, 0
        for n in self.names:
            offs[n] = total
            total += math.prod(self.shapes[n])
        Z = total

        def m(name):
            return np.arange(offs[name], offs[name] + math.prod(self.shapes[name]),
                             dtype=np.int64).reshape(self.shapes[name])

        def h_part(i):  # a skip layer's rows for h follow those for x
            w = m(f"pts.{i}.w")
            return w[ic:] if (i - 1) in nerf.skips else w

        wv = m("views.0.w")
        wvd = _pad(wv[W:], X, H, Z, at=(ic, 0))  # views rows at their x columns
        mats = {"pts.0": _pad(m("pts.0.w"), X, W, Z), "feature": m("feature.w"),
                "views.f": wv[:W], "views.x": wvd}
        for i in range(1, D):
            mats[f"pts.{i}"] = h_part(i)
            if (i - 1) in nerf.skips:
                mats[f"pts.{i}.x"] = _pad(m(f"pts.{i}.w")[:ic], X, W, Z)
        self.plan = stream_plan(D, nerf.skips, W, X)
        streams = []
        for plan in self.plan:
            parts = []
            for what, K, N in plan:
                name, _, c0 = what.partition("@")
                a = mats[name[:-2]].T if name.endswith("^T") else mats[name]
                a = a[:, int(c0 or 0):int(c0 or 0) + N]
                assert a.shape == (K, N), (what, a.shape)
                parts.append(chunk_order(a, Z))
            streams.append(np.concatenate(parts))
        self._fwd_idx, self._bwd_idx = streams

        P = K3Params()
        vec = []

        def put(a):  # 4-float aligned slots of the fp32 vector buffer
            off = sum(v.size for v in vec)
            a = np.asarray(a, np.int64).reshape(-1)
            vec.append(np.concatenate([a, np.full(-a.size % 4, Z, np.int64)]))
            return off
        self.b = [put(m(f"pts.{i}.b")) for i in range(D)]
        assert self.b == [i * W for i in range(D)]  # the fused kernels' stride
        P.bf, P.bv = put(m("feature.b")), put(m("views.0.b"))
        P.brgb, P.ba = put(m("rgb.b")), put(m("alpha.b"))
        P.wa = put(m("alpha.w"))  # the heads' weights, rounded to bf16 at packing
        P.wrgb = put(m("rgb.w"))
        self._vec_idx = np.concatenate(vec)
        self._vec_round = P.wa

        # bias-partial columns, which are also the head of the grads buffer:
        # trunk, feature, views biases; rgb.b, alpha.b; alpha.w, rgb.w
        self.bp = [i * W for i in range(D)]
        P.bp_f, P.bp_v = D * W, D * W + W
        P.bp_rgb = P.bp_v + H
        P.bp_a = P.bp_rgb + 3
        P.bp_wa = P.bp_a + 1
        P.bp_wrgb = P.bp_wa + W
        P.bp_width = P.bp_wrgb + 3 * H
        self.grad_slices = {f"pts.{i}.b": self.bp[i] for i in range(D)}
        self.grad_slices.update({"feature.b": P.bp_f, "views.0.b": P.bp_v, "rgb.b": P.bp_rgb,
                                 "alpha.b": P.bp_a, "alpha.w": P.bp_wa, "rgb.w": P.bp_wrgb})
        at = P.bp_width
        for n in self.names:
            if n not in self.grad_slices:
                self.grad_slices[n] = at
                at += math.prod(self.shapes[n])
        self.grad_size = at
        P.n_in, P.depth = n_in, D
        self.skip = [int(i > 0 and (i - 1) in nerf.skips) for i in range(D)]
        P.skip_bits = sum(1 << (i - 1) for i in range(1, min(D, FUSED_DEPTH)) if self.skip[i])
        self.params = P
        self._tables: Dict[Tuple[int, str], Tuple] = {}
        self._index: Dict[str, List[torch.Tensor]] = {}

    # -- the plain version ---------------------------------------------------

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The module's bf16 forward: bf16 operands, fp32 accumulation."""
        return self.nerf(x, dtype=torch.bfloat16)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        leaves = [p for _, p in self.nerf.named_parameters()]
        lead = x.shape[:-1]
        out = _K3Function.apply(x.reshape(-1, x.shape[-1]), self, *leaves)
        return out.reshape(*lead, 4)

    # -- layouts -------------------------------------------------------------

    def pack(self, named: Dict[str, torch.Tensor], device) -> Tuple[torch.Tensor, ...]:
        """(forward stream, backward stream) in bf16 and the fp32 vector
        buffer, gathered from the current parameters."""
        flat = torch.cat([named[n].detach().reshape(-1).float() for n in self.names] +
                         [torch.zeros(1, device=named[self.names[0]].device)]).to(device)
        key = str(device)
        if key not in self._index:  # uploaded once per device
            self._index[key] = [torch.from_numpy(i).to(device)
                                for i in (self._fwd_idx, self._bwd_idx, self._vec_idx)]
        gather = [flat[i] for i in self._index[key]]
        vec = gather[2]
        vec[self._vec_round:] = vec[self._vec_round:].to(torch.bfloat16).float()
        return gather[0].to(torch.bfloat16), gather[1].to(torch.bfloat16), vec

    def tiles(self, N: int) -> int:
        """64-row tiles the kernels walk for N rows: an even count (a block
        tile is two)."""
        return 2 * math.ceil(N / (2 * TILE_ROWS))

    def scratch_layout(self, N: int) -> Dict[str, Tuple[int, int]]:
        """{matrix: (element offset, features)} of the backward's scratch:
        x, each trunk layer's output h.i, the feature, the views output hv,
        each trunk layer's output cotangent g.i (after its relu mask), and
        the feature's and views layer's, g.feat and g.hv."""
        D, W = self.nerf.depth, self.width
        order = [("x", self.xw)] + [(f"h.{i}", W) for i in range(D)] + \
            [("feat", W), ("hv", W // 2)] + [(f"g.{i}", W) for i in range(D)] + \
            [("g.feat", W), ("g.hv", W // 2)]
        out, off, T = {}, 0, self.tiles(N)
        for name, F in order:
            out[name] = (off, F)
            off += T * TILE_ROWS * F
        out[""] = (off, 0)
        return out

    def new_scratch(self, N: int, device) -> torch.Tensor:
        """The backward's bf16 scratch for N rows."""
        return torch.empty(self.scratch_layout(N)[""][0], dtype=torch.bfloat16, device=device)

    def scratch_matrix(self, scratch: torch.Tensor, N: int, name: str) -> torch.Tensor:
        """One matrix of a used scratch, (N, F), by its ``scratch_layout``
        name."""
        off, F = self.scratch_layout(N)[name]
        return untile_rows(scratch[off:], self.tiles(N), F, N)

    def relu_outputs(self, scratch: torch.Tensor, N: int) -> List[torch.Tensor]:
        """A used scratch's bf16 relu outputs: each trunk layer's (N, W),
        then the views layer's (N, W / 2)."""
        return [self.scratch_matrix(scratch, N, f"h.{i}") for i in range(self.nerf.depth)] + \
            [self.scratch_matrix(scratch, N, "hv")]

    def dw_tiles(self, N: int) -> List[DwTile]:
        """The weight-gradient table for N rows: per gradient (or its x
        rows), its output tiles of at most two 64-row slabs of A's features
        by at most 256 of B's columns; dst offsets index the grads
        buffer."""
        lay, W, ic, D = self.scratch_layout(N), self.width, self.nerf.input_ch, self.nerf.depth
        out = []

        def job(a, k_lo, k_hi, b, leaf, row0):
            (sa, fa), (sb, fb) = lay[a], lay[b]
            ldo = self.shapes[leaf][1]
            for c0, n in passes(fb):
                for s0 in range(k_lo // 64, math.ceil(k_hi / 64), 2):
                    t = DwTile()
                    t.a, t.b = sa + s0 * 64 * 64, sb + c0 * TILE_ROWS
                    t.a_stride, t.b_stride, t.n = TILE_ROWS * fa, TILE_ROWS * fb, n
                    t.nslab = min(2, math.ceil(k_hi / 64) - s0)
                    t.k0, t.k_lo, t.k_hi = 64 * s0, k_lo, k_hi
                    t.ldo, t.m_valid = ldo, n
                    t.dst = self.grad_slices[leaf] + row0 * ldo + c0
                    out.append(t)
        job("x", 0, ic, "g.0", "pts.0.w", 0)
        for i in range(1, D):
            skip = (i - 1) in self.nerf.skips
            job(f"h.{i - 1}", 0, W, f"g.{i}", f"pts.{i}.w", ic if skip else 0)
            if skip:
                job("x", 0, ic, f"g.{i}", f"pts.{i}.w", 0)
        job(f"h.{D - 1}", 0, W, "g.feat", "feature.w", 0)
        job("feat", 0, W, "g.hv", "views.0.w", 0)
        job("x", ic, self.n_in, "g.hv", "views.0.w", W)
        return out

    def grads_from(self, gbuf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{leaf: grad} views of a grads buffer."""
        return {n: gbuf[o:o + math.prod(self.shapes[n])].view(self.shapes[n])
                for n, o in self.grad_slices.items()}

    # -- launches ------------------------------------------------------------

    def _check(self, x: torch.Tensor):
        if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != self.n_in \
                or not x.is_contiguous():
            raise ValueError(f"x must be a contiguous (N, {self.n_in}) float32 tensor")

    def _params(self, N: int, device) -> K3Params:
        P = K3Params.from_buffer_copy(self.params)
        lay = self.scratch_layout(N)
        P.N, P.tiles = N, self.tiles(N)
        P.blocks = min(P.tiles // 2, torch.cuda.get_device_properties(device).multi_processor_count)
        P.s_x, P.s_h, P.s_g = lay["x"][0], lay["h.0"][0], lay["g.0"][0]
        P.s_step = P.tiles * TILE_ROWS * self.width  # from one layer's region to the next's
        P.s_feat, P.s_hv, P.s_gfeat, P.s_ghv = (lay[k][0] for k in ("feat", "hv", "g.feat", "g.hv"))
        return P

    def _table(self, N: int, device):
        """(device table, count, slices, row tiles per slice) for N rows,
        uploaded once per (N, device)."""
        key = (N, str(device))
        if key not in self._tables:
            tiles = self.dw_tiles(N)
            raw = bytes((DwTile * len(tiles))(*tiles))
            dev = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)
            T = self.tiles(N)
            self._tables[key] = (dev, len(tiles), math.ceil(T / DW_SLICE_TILES), DW_SLICE_TILES)
        return self._tables[key]

    def products(self) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
        """(forward, backward): [(chunks of 64 rows a pass, columns)] of each
        product of the weight streams in walk order: the groups of
        ``stream_plan``'s entries that one wide GEMM reads."""
        D, W, X, H = self.nerf.depth, self.width, self.xw, self.width // 2
        kw, kx, kv = W // TC_KC, X // TC_KC, H // TC_KC  # chunks of each input
        fwd = [(kx, W)] + [(kw + kx * self.skip[i], W) for i in range(1, D)]
        fwd += [(kw, W), (kw + kx, H)]
        bwd = [(kv, X), (kv, W), (kw, W)]
        for i in range(D - 1, 0, -1):
            bwd += [(kw, X)] * self.skip[i] + [(kw, W)]
        return fwd, bwd + [(kw, X)]

    def _offsets(self, which: int) -> List[int]:
        """Element offset of each product in the forward (0) or backward (1)
        stream."""
        out, at = [], 0
        for kc, n in self.products()[which]:
            out.append(at)
            at += kc * TC_KC * n
        return out

    def forward_kernel(self, x: torch.Tensor, packed) -> torch.Tensor:
        self._check(x)
        N = x.shape[0]
        out = torch.empty((N, 4), dtype=torch.float32, device=x.device)
        if self.wide:
            self._forward_wide(x, packed, out)
        else:
            P = self._params(N, x.device)
            fs, _, vec = packed
            rc = _library(self.width).k3_forward(
                _device_index(x), ctypes.byref(P), x.data_ptr(), fs.data_ptr(), vec.data_ptr(),
                out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"nerf_train forward launch failed: CUDA error {rc}")
        NerfTrainKernel.forward_launches += 1
        NerfTrainKernel.forward_rows = N
        return out

    def backward_kernel(self, x, g, packed, scratch=None):
        """Returns (dx (N, n_in), {leaf name: fp32 grad}). ``scratch``, from
        ``new_scratch(N)``, lets the caller read the recomputed activations
        and the cotangents afterwards (``scratch_matrix``)."""
        self._check(x)
        g = g.to(torch.float32).contiguous()
        N, dev = x.shape[0], x.device
        P = self._params(N, dev)
        if scratch is None:
            scratch = self.new_scratch(N, dev)
        dx = torch.empty((N, self.n_in), dtype=torch.float32, device=dev)
        gbuf = torch.empty(self.grad_size, dtype=torch.float32, device=dev)
        table, n_tiles, S, tps = self._table(N, dev)
        part = torch.empty(n_tiles * S * DW_PART, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if self.wide:
            bpart = torch.empty((P.tiles // 2, P.bp_width), dtype=torch.float32, device=dev)
            self._chain_wide(x, g, packed, scratch, bpart, dx)
            rc = _library(WIDTHS[1]).k3_weight_grads(
                _device_index(x), table.data_ptr(), n_tiles, S, tps, P.tiles, scratch.data_ptr(),
                part.data_ptr(), bpart.data_ptr(), P.tiles // 2, P.bp_width, gbuf.data_ptr(),
                stream)
        else:
            slots = 2 * P.blocks
            masks = torch.empty(P.tiles * (self.nerf.depth + 1) * 2 * self.width,
                                dtype=torch.int32, device=dev)
            bpart = torch.empty((slots, P.bp_width), dtype=torch.float32, device=dev)
            fs, bs, vec = packed
            rc = _library(self.width).k3_backward(
                _device_index(x), ctypes.byref(P), x.data_ptr(), g.data_ptr(), fs.data_ptr(),
                bs.data_ptr(), vec.data_ptr(), scratch.data_ptr(), masks.data_ptr(),
                bpart.data_ptr(), dx.data_ptr(), table.data_ptr(), n_tiles, S, tps,
                part.data_ptr(), gbuf.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"nerf_train backward launch failed: CUDA error {rc}")
        NerfTrainKernel.backward_launches += 1
        return dx, self.grads_from(gbuf)

    # -- the wide path -------------------------------------------------------

    def _forward_layers(self, x, packed, st=None):
        """The forward's layers on the wide path, the scratch written where
        ``st`` (the scratch) is given (the recompute). Returns the tile
        buffer holding the views output, the other one, and (without st)
        the alpha head's output."""
        N, dev = x.shape[0], x.device
        T, W, D, xw = self.tiles(N), self.width, self.nerf.depth, self.xw
        P = self.params
        fs, _, vec = packed
        lay = self.scratch_layout(N)
        fo, fp, vp = self._offsets(0), fs.data_ptr(), vec.data_ptr()

        def s(name):  # a scratch matrix's address, or None
            return None if st is None else st.data_ptr() + 2 * lay[name][0]
        xt = torch.empty(T * TILE_ROWS * xw, dtype=torch.bfloat16, device=dev)
        wide.rows_kernel("load_x", dev, x, N, self.n_in, xw, T, xt, s("x"))
        h = [torch.empty(T * TILE_ROWS * W, dtype=torch.bfloat16, device=dev) for _ in range(2)]
        a, kc = xt, xw // TC_KC
        for l in range(D):
            skip = self.skip[l]
            wide.gemm(dev, a, kc, fp + 2 * fo[l], W, N, a1=xt if skip else None,
                      kc1=xw // TC_KC if skip else 0, bias=vp + 4 * self.b[l], relu=True,
                      out=h[l % 2], st=s(f"h.{l}"))
            a, kc = h[l % 2], W // TC_KC
        t, f = h[(D - 1) % 2], h[D % 2]
        wide.gemm(dev, t, W // TC_KC, fp + 2 * fo[D], W, N, bias=vp + 4 * P.bf, out=f,
                  st=s("feat"))
        alpha = None
        if st is None:  # the alpha head, from the trunk output
            alpha = torch.empty(N, dtype=torch.float32, device=dev)
            wide.rows_kernel("head", dev, 0, 1, 0, t, W, vp + 4 * P.wa, vp + 4 * P.ba, alpha,
                             None, None, 0, N, None)
        wide.gemm(dev, f, W // TC_KC, fp + 2 * fo[D + 1], W // 2, N, a1=xt, kc1=xw // TC_KC,
                  bias=vp + 4 * P.bv, relu=True, out=t, st=s("hv"))
        return t, f, alpha

    def _forward_wide(self, x, packed, out):
        """k3_fwd on the wide path: the layers, then the heads into out."""
        hv, _, alpha = self._forward_layers(x, packed)
        vp = packed[2].data_ptr()
        wide.rows_kernel("head", x.device, 1, 1, 0, hv, self.width // 2,
                         vp + 4 * self.params.wrgb, vp + 4 * self.params.brgb, alpha, None, None, 0,
                         x.shape[0], out)

    def _chain_wide(self, x, g, packed, scratch, bpart, dx):
        """k3_recompute and k3_chain on the wide path: the recompute into
        the scratch and the heads' gradients; then the cotangents from the
        views layer down, each masked by its layer's relu (read from the
        scratch), summed into its bias-partial columns (a row per 128-row
        tile), rounded into the scratch and the next product's A; and dX's
        terms."""
        N, dev = x.shape[0], x.device
        T, W, D, xw = self.tiles(N), self.width, self.nerf.depth, self.xw
        H, P = W // 2, self.params
        lay = self.scratch_layout(N)
        bo, bp, vp = self._offsets(1), packed[1].data_ptr(), packed[2].data_ptr()
        pb, ld = bpart.data_ptr(), P.bp_width

        def s(name):
            return scratch.data_ptr() + 2 * lay[name][0]
        G, O, _ = self._forward_layers(x, packed, scratch)
        wide.rows_kernel("head_grads", dev, s(f"h.{D - 1}"), s("hv"), W, N, T, g, bpart, ld,
                         P.bp_wa, P.bp_wrgb, P.bp_rgb, P.bp_a)
        wide.rows_kernel("ghv", dev, s("hv"), s("g.hv"), H, N, T, g, vp + 4 * P.wrgb, bpart, ld,
                         P.bp_v, G)

        def dx_term(a, kc, k, first=False):
            wide.gemm(dev, a, kc, bp + 2 * bo[k], xw, N, f32=dx, ldf=self.n_in,
                      f32_cols=self.n_in, f32_add=not first)

        def cot(a, kc, k, n, col, out, name, mask=None, rank1=False):
            wide.gemm(dev, a, kc, bp + 2 * bo[k], n, N, mask=mask, bp=pb + 4 * col, ldbp=ld,
                      out=out, st=s(name), ga=g if rank1 else None,
                      wa=vp + 4 * P.wa if rank1 else None)
        dx_term(G, H // TC_KC, 0, first=True)                       # g_hv @ wv_x^T
        cot(G, H // TC_KC, 1, W, P.bp_f, O, "g.feat")               # g_feat
        cot(O, W // TC_KC, 2, W, self.bp[D - 1], G, f"g.{D - 1}",   # the trunk output's
            mask=s(f"h.{D - 1}"), rank1=True)
        k, cur, nxt = 3, G, O
        for i in range(D - 1, 0, -1):
            if self.skip[i]:
                dx_term(cur, W // TC_KC, k)
                k += 1
            cot(cur, W // TC_KC, k, W, self.bp[i - 1], nxt, f"g.{i - 1}", mask=s(f"h.{i - 1}"))
            k, cur, nxt = k + 1, nxt, cur
        dx_term(cur, W // TC_KC, k)

class _K3Function(torch.autograd.Function):
    """out = K3(x; NeRF leaves); the backward is the kernel's backward and
    returns fp32 grads for x and every leaf, like the TPU kernel's
    custom_vjp."""

    @staticmethod
    def forward(ctx, x, kernel, *leaves):
        x = x.to(torch.float32).contiguous()
        packed = kernel.pack(dict(zip(kernel.names, leaves)), x.device)
        ctx.kernel = kernel
        ctx.save_for_backward(x, *packed)
        return kernel.forward_kernel(x, packed)

    @staticmethod
    def backward(ctx, g):
        x, *packed = ctx.saved_tensors
        k = ctx.kernel
        dx, grads = k.backward_kernel(x, g, packed)
        return (dx if ctx.needs_input_grad[0] else None, None, *[grads[n] for n in k.names])


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _library(width: int):
    lib = build.load(library(width))
    if not getattr(lib, "_k3_bound", False):
        lib.k3_forward.argtypes = [ctypes.c_int, ctypes.POINTER(K3Params)] + [ctypes.c_void_p] * 5
        lib.k3_forward.restype = ctypes.c_int
        lib.k3_backward.argtypes = [ctypes.c_int, ctypes.POINTER(K3Params)] + \
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
        lib.k3_backward.restype = ctypes.c_int
        lib.k3_weight_grads.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        lib.k3_weight_grads.restype = ctypes.c_int
        lib.k3_struct_size.argtypes = [ctypes.c_int]
        lib.k3_struct_size.restype = ctypes.c_int
        for which, cls in ((0, K3Params), (1, DwTile)):
            if lib.k3_struct_size(which) != ctypes.sizeof(cls):
                raise RuntimeError(f"{cls.__name__} layout differs: C {lib.k3_struct_size(which)} "
                                   f"bytes, ctypes {ctypes.sizeof(cls)} bytes")
        if lib.k3_struct_size(2) != width:
            raise RuntimeError(f"{library(width)} is built for width {lib.k3_struct_size(2)}")
        lib._k3_bound = True
    return lib
