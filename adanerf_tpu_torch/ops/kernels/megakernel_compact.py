"""K1: the compacted adaptive frame renderer, as one hand-written CUDA kernel
source (``csrc/megakernel_compact.cu``) beside its plain PyTorch version.

Replaces ``adanerf_tpu/ops/pallas/megakernel3.py::make_megakernel_compact``.
``MegakernelCompact(renderer)`` packs the renderer's two MLPs once; calling
it renders a batch of rays to ``(rgb (B, 3), counts (B,))``:

  * on a CUDA tensor it launches the kernel (a front, a shade and a
    composite on the current stream, no host synchronisation) and counts
    the call in ``launches``;
  * on a CPU tensor it runs the plain version, ``plain``, which is the
    renderer's own PyTorch path (``adanerf_tpu_torch/realtime.py``).

The front runs the oracle and the shade the NeRF, each in the fused
library of its MLP's width (128 or 256: ``WIDTHS``, one library each,
``library``), so the two MLPs may differ in width; an MLP of any other
width (384 and up, where the wide path measured faster than the fused
kernels, or not a multiple of 128) takes the wide path for its half
(``csrc/wide.cu``, ``wide.py``: its layers one at a time, the
activations in device memory, each width padded with zeros to a multiple
of 64). Depth has no cap: the kernels read each layer's offsets
from a table on the device. ``refusal`` says why K1 does not take an
export, naming the JAX line that refuses the same, and the viewer's
default route asks it.

The kernel takes the renderer's precision: fp32 weights when
``renderer.dtype`` is None, bf16 weights and bf16-rounded matmul inputs
with fp32 accumulation when it is ``torch.bfloat16``. Both precisions pack
the matrices in the order the tensor-core kernels walk them
(``stream_plan``), in two layouts. fp32 keeps each matrix row-major for the
FMA layer (``csrc/mlp_tile.cuh``), which reads it by its offset. bf16
writes each MLP as one stream of weight chunks for the tensor-core layer
(``csrc/mlp_wgmma.cuh``), already in the byte layout of its shared-memory
stages (``swizzle128``), so that each chunk arrives by one bulk copy.
"""

from __future__ import annotations

import copy
import ctypes
import math
from types import SimpleNamespace

import numpy as np
import torch

from . import build, wide

SOURCE = "megakernel_compact.cu"
WIDTHS = (128, 256)  # MLP widths of the fused libraries, one library each
FUSED_DEPTH = 65  # the fused shade's most NeRF layers (MkParams::skip_bits)
ALIGN = 64   # element alignment of each packed matrix
CHUNK = 1 << 18  # sample rows of one wide shade pass (its activation buffers)


class MkParams(ctypes.Structure):
    """Mirror of ``struct MkParams`` in ``csrc/megakernel.cuh``, field for
    field; ``lt`` is the device address of the per-layer table
    (``MegakernelCompact.table``)."""
    _fields_ = [("lt", ctypes.c_void_p)] + \
        [(k, ctypes.c_longlong) for k in ("o_b0", "n_b0")] + [("skip_bits", ctypes.c_ulonglong)] + \
        [(k, ctypes.c_longlong) for k in ("n_wa", "n_ba", "n_wf", "n_bf", "n_wvf", "n_wvd", "n_bv",
                                          "n_wrgb", "n_brgb")] + \
        [(k, ctypes.c_int) for k in ("B", "S", "D", "in0", "in1", "fd0", "fp0",
                                     "fp1", "fd1", "depth0", "depth1", "z_mode", "ndc",
                                     "norm_none", "acc_mode", "bf16", "from_stage", "stages",
                                     "shade_blocks")] + \
        [(k, ctypes.c_float) for k in ("threshold", "radius2", "sqrt_max_depth")] + \
        [("center", ctypes.c_float * 3)] + \
        [(k, ctypes.c_float) for k in ("z_a", "z_b", "ndc_wf", "ndc_hf")]


PASS = 256  # widest output a wgmma pass takes: wider layers run in passes
TC_KC = 64  # K rows of a bf16 weight chunk: one 128-byte swizzle atom of bf16
# rows one walk of a bf16 stream serves: a block's two 64-row consumers
# read every chunk it fetches from L2
TC_ROWS_PER_WALK = 128


def _pad(n: int, m: int) -> int:
    return m * math.ceil(n / m)


def library(source: str, width: int) -> str:
    """The library (``build`` name) of a frame kernel's source at an MLP
    width: the source as it is at 256, its ``MLP_WIDTH`` variant at the
    others."""
    return source if width == 256 else build.variant(source, "MLP_WIDTH", width)


def passes(n: int):
    """[(first column, columns)] of the wgmma passes of an n-column layer:
    one up to 256 columns, else 256 and the rest (csrc/mlp_wgmma.cuh's
    tc_passes)."""
    return [(c0, min(PASS, n - c0)) for c0 in range(0, n, PASS)]


def swizzle128(n_rows: int) -> np.ndarray:
    """(n_rows, 64) int: where element (n, k) of a bf16 weight chunk (n_rows
    x 64, K-major) sits in the chunk's flat layout. Row n takes 128 bytes,
    and its 16-byte group k // 8 sits at group (k // 8) ^ (n % 8): the
    128-byte swizzle that ``csrc/mlp_wgmma.cuh`` (``sw128``) and wgmma's
    descriptors read."""
    n = np.arange(n_rows)[:, None]
    k = np.arange(TC_KC)[None, :]
    return n * TC_KC + ((k // 8) ^ (n % 8)) * 8 + k % 8


def unpack_chunks(flat: np.ndarray, off: int, rows: int, n: int) -> np.ndarray:
    """The (rows, n) matrix that ``_Packer.chunks`` wrote at element ``off``
    of ``flat`` (rows a multiple of 64), as the kernel reads it back."""
    idx = swizzle128(n)
    chunks = flat[off:off + rows * n].reshape(rows // TC_KC, n * TC_KC)
    return np.concatenate([c[idx].T for c in chunks])


def stream_plan(mk, front: bool):
    """[(kc0, kc1, n)] for each weight layer of a wrapper's bf16 stream, as
    ``csrc/megakernel.cuh::tc_plan`` walks it (and the wide path's GEMMs
    read it, product by product): kc0 chunks of the layer's first input,
    kc1 of the encoded input x (a NeRF skip layer, the views layer), n
    output columns (a layer wider than 256 comes pass by pass, ``passes``:
    each pass's kc0 + kc1 chunks). The front walks the oracle (its own
    width), the shade the NeRF trunk, the feature layer and the views layer
    (half the NeRF's width)."""
    P, L = mk.params, mk.layers
    W0, W, H = mk.padded
    if front:
        return [(P.in0 // TC_KC if l == 0 else W0 // TC_KC, 0,
                 128 if l == P.depth0 - 1 else W0) for l in range(P.depth0)]
    plan = [(P.in1 // TC_KC, 0, W)]
    for l in range(1, P.depth1):
        plan.append((W // TC_KC, P.in1 // TC_KC if L.n_wx[l] >= 0 else 0, W))
    return plan + [(W // TC_KC, 0, W), (W // TC_KC, P.in1 // TC_KC, H)]


def stream_bytes(mk, front: bool) -> int:
    """Bytes of one walk of a bf16 stream: what TC_ROWS_PER_WALK rows of
    the fused kernels, or each 128-row block of a wide GEMM, read from
    L2."""
    return sum((kc0 + kc1) * n * TC_KC * 2 for kc0, kc1, n in stream_plan(mk, front))


def unpack_layer(flat: np.ndarray, off: int, kcs, n: int):
    """The matrices (kc * 64 rows, n columns each, for kc in kcs; None where
    kc is 0) of one layer that ``_Packer.layer`` wrote at element ``off``,
    pass by pass, as the kernel reads them back; and the offset past it."""
    parts = [[] for _ in kcs]
    for _, np_ in passes(n):
        for m, kc in enumerate(kcs):
            if kc:
                parts[m].append(unpack_chunks(flat, off, kc * TC_KC, np_))
                off += kc * TC_KC * np_
    return [np.concatenate(p, axis=1) if p else None for p in parts], off


class _Packer:
    """Appends matrices / bias vectors to flat buffers, returning offsets."""

    def __init__(self):
        self.w, self.b = [], []
        self.nw = self.nb = 0

    @staticmethod
    def _pad(a, rows, cols):
        out = np.zeros((rows, cols), np.float32)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    def mat(self, a, rows=None, cols=None):
        a = np.asarray(a, np.float32)
        if a.ndim == 1:
            a = a[:, None]
        a = self._pad(a, rows or a.shape[0], cols or a.shape[1])
        off = self.nw
        flat = np.zeros(ALIGN * math.ceil(a.size / ALIGN), np.float32)
        flat[:a.size] = a.reshape(-1)
        self.w.append(flat)
        self.nw += flat.size
        return off

    def layer(self, mats, n):
        """Appends one layer's input matrices [(a (K, <= n), rows or None)]
        as bf16 weight chunks: rows padded with zeros to ``rows`` (default K)
        and then to a multiple of 64, columns to n; pass by pass
        (``passes``), each matrix's columns of the pass as 64-row blocks,
        each transposed to (pass columns, 64) and laid out by
        ``swizzle128``, one after the other. Returns each matrix's offset
        (of its first chunk)."""
        padded = [self._pad(np.asarray(a, np.float32), _pad(rows or a.shape[0], TC_KC), n)
                  for a, rows in mats]
        offs = [None] * len(mats)
        for c0, np_ in passes(n):
            idx = swizzle128(np_)
            for m, a in enumerate(padded):
                out = np.zeros((a.shape[0] // TC_KC, np_ * TC_KC), np.float32)
                for c in range(out.shape[0]):
                    out[c, idx] = a[c * TC_KC:(c + 1) * TC_KC, c0:c0 + np_].T
                if offs[m] is None:
                    offs[m] = self.nw
                self.w.append(out.reshape(-1))
                self.nw += out.size
        return offs

    def vec(self, v, n=None):
        v = np.asarray(v, np.float32).reshape(-1)
        flat = np.zeros(ALIGN * math.ceil(max(n or v.size, v.size) / ALIGN), np.float32)
        flat[:v.size] = v
        off = self.nb
        self.b.append(flat)
        self.nb += flat.size
        return off


def _numpy_state(module):
    return {k: v.detach().float().cpu().numpy() for k, v in module.state_dict().items()}


def _precision(dtype):
    return "fp32" if dtype is None else str(dtype).replace("torch.", "")


def refusal(renderer):
    """Why K1 (and K2, which adds refusals of its own) does not take this
    renderer's export, or None when it does; each reason names the line of
    the JAX package that refuses the same. The wrapper raises it; the
    viewer's default route asks it to choose between K1 and the plain
    path."""
    rt, cfg = renderer, renderer.config
    oracle, nerf = rt.oracle, rt.nerf
    if renderer.dtype not in (None, torch.bfloat16):
        return (f"kernel precision is fp32 or bf16, got {renderer.dtype} (as the JAX kernel's: "
                "megakernel3.py:62 _PRECISIONS)")
    # the kernels are built for one precision each, as the JAX kernel packs
    # both MLPs at one pack_dtype; a renderer's per-net precisions
    # (RealtimeRenderer(oracle_dtype=, nerf_dtype=)) run on the plain path
    o = getattr(renderer, "oracle_dtype", renderer.dtype)
    n = getattr(renderer, "nerf_dtype", renderer.dtype)
    if o != renderer.dtype or n != renderer.dtype:
        return (f"mixed precision (oracle {_precision(o)}, NeRF {_precision(n)}): the kernels "
                "run both MLPs at one precision, fp32 or bf16, as the JAX kernel packs both at "
                "one pack_dtype (viewer.py:234-236); render it on the plain path")
    if list(cfg.posEnc) != ["nerf", "nerf"]:
        return (f"kernel implements the nerf encoding, got {cfg.posEnc} (as the JAX kernel's "
                "lane tables: megakernel.py:209 lane_encode_tables)")
    S = rt.max_samples
    if not (rt.threshold > 0.0 and 1 <= S <= 16):
        return (f"kernel needs an adaptive model (adaptiveSamplingThreshold > 0) of at most 16 "
                f"samples (this one has threshold {rt.threshold}, S={S}; the JAX viewer's "
                "viewer.py:206 and megakernel3.py:269 refuse the same)")
    if oracle.n_out > 128:
        return (f"kernel takes at most 128 oracle bins, got {oracle.n_out} (the JAX kernel "
                "selects in one 128-lane row: megakernel3.py:257, LANE megakernel3.py:56)")
    if rt.norm_name not in ("InverseSqrtDistCentered", "None", "none"):
        # an absent key means MaxDepth, which the kernel does not implement
        return (f"kernel supports rayMarchNormalization[1] in "
                f"('InverseSqrtDistCentered', 'None'); got {rt.norm_name!r} "
                "(megakernel3.py:292-295 refuses the same)")
    if oracle.skip:
        return ("kernel needs a skip-free oracle (the JAX kernel's oracle MLP takes no skip "
                "input: megakernel.py:159 _oracle_mlp)")
    fp0, fd0 = [int(x) for x in cfg.posEncArgs[0].split('-')]
    fp1, fd1 = [int(x) for x in cfg.posEncArgs[1].split('-')]
    in_ch, in_views = nerf.input_ch, nerf.input_ch_views
    if in_ch != 6 * fp1 + 3 or in_views != 6 * fd1 + 3 \
            or oracle.n_in != 6 * (fp0 + fd0) + 6:
        return ("MLP input widths do not match posEncArgs (the JAX kernel encodes by "
                "posEncArgs: megakernel3.py:303-304)")
    if oracle.n_in > 128 or in_ch + in_views > 128:
        return ("encoded inputs wider than 128 columns (the JAX kernel's lane tables refuse "
                "them: megakernel.py:246)")
    return None


class MegakernelCompact:
    """K1 wrapper around a ``RealtimeRenderer`` (the plain version).

    The front (oracle) runs the fused kernel of the oracle's width, the
    shade (NeRF) that of the NeRF's; an MLP of another width (or an oracle
    of one layer, a NeRF of more than FUSED_DEPTH) takes the wide path
    (``wide.py``) for its half.
    ``MegakernelCompact.launches`` counts kernel calls over all instances,
    so a caller can show that a run went through the kernel."""

    launches = 0
    SOURCE, SYMBOL = SOURCE, "mk_compact_launch"
    DENSE = False  # K2 (megakernel_dense.py) shades every slot

    def __init__(self, renderer):
        self.renderer = renderer
        reason = refusal(renderer)
        if reason is not None:
            raise ValueError(reason)
        rt, cfg, sc = renderer, renderer.config, renderer.scene
        oracle, nerf = rt.oracle, rt.nerf
        self.widths = W0, W = oracle.width, nerf.width
        # the widths the kernels compute at: the MLPs' and the views layer's,
        # each padded with zero columns (and the next layer's zero rows) to
        # a multiple of 64, the tensor-core layer's K block (the fused
        # widths are multiples of 128 already)
        self.padded = Wp0, Wp, Hp = tuple(_pad(n, TC_KC) for n in (W0, W, W // 2))
        self.front_wide = W0 not in WIDTHS or oracle.depth < 2
        self.shade_wide = W not in WIDTHS or nerf.depth > FUSED_DEPTH
        D, S = oracle.n_out, rt.max_samples
        fp0, fd0 = [int(x) for x in cfg.posEncArgs[0].split('-')]
        fp1, fd1 = [int(x) for x in cfg.posEncArgs[1].split('-')]
        in_ch, in_views = nerf.input_ch, nerf.input_ch_views
        bf16 = renderer.dtype is torch.bfloat16
        # the tensor-core layer takes K in 64-column blocks
        in0, in1 = (_pad(n, TC_KC if bf16 else 32) for n in (oracle.n_in, in_ch + in_views))

        P = MkParams()
        pk = _Packer()
        L = self.layers = SimpleNamespace(o_w=[], o_b=[], n_w=[], n_wx=[], n_b=[])
        # both precisions pack the matrices in stream_plan's order: the
        # oracle, then the NeRF trunk (a skip layer's h rows before its x
        # rows), the feature and views layers, then the row-major heads. bf16
        # writes each layer as stream chunks, pass by pass, which the fused
        # kernels walk from o_w[0] and n_w[0] and the wide path's GEMMs read
        # layer by layer; fp32 keeps them row-major, read by their offsets
        mat = (lambda a, rows=None, cols=None: pk.layer([(a, rows)], cols or a.shape[1])[0]) \
            if bf16 else pk.mat
        ow = _numpy_state(oracle)
        for i in range(oracle.depth):
            last = i == oracle.depth - 1
            L.o_w.append(mat(ow[f"{i}.w"], rows=in0 if i == 0 else Wp0,
                             cols=128 if last else Wp0))
            L.o_b.append(pk.vec(ow[f"{i}.b"], 128 if last else None))
        nw = _numpy_state(nerf)
        L.n_w.append(mat(nw["pts.0.w"], rows=in1, cols=Wp))
        L.n_wx.append(-1)
        L.n_b.append(pk.vec(nw["pts.0.b"]))
        for i in range(1, nerf.depth):
            w = nw[f"pts.{i}.w"]
            skip = (i - 1) in nerf.skips  # input is [input_pts, h]
            if skip and bf16:  # [h, x] pass by pass
                wh, wx = pk.layer([(w[in_ch:], Wp), (w[:in_ch], in1)], Wp)
            else:
                wh = mat(w[in_ch:] if skip else w, rows=Wp, cols=Wp)
                wx = mat(w[:in_ch], rows=in1, cols=Wp) if skip else -1
            L.n_w.append(wh)
            L.n_wx.append(wx)
            L.n_b.append(pk.vec(nw[f"pts.{i}.b"]))
        P.n_wf, P.n_bf = mat(nw["feature.w"], rows=Wp, cols=Wp), pk.vec(nw["feature.b"])
        wv = nw["views.0.w"]  # input is [feature W | dirs in_views]
        wvd = np.zeros((in1, Hp), np.float32)
        wvd[in_ch:in_ch + in_views, :W // 2] = wv[W:]
        if bf16:  # [feature, x] pass by pass
            P.n_wvf, P.n_wvd = pk.layer([(wv[:W], Wp), (wvd, None)], Hp)
        else:
            P.n_wvf, P.n_wvd = mat(wv[:W], rows=Wp, cols=Hp), mat(wvd)
        P.n_bv = pk.vec(nw["views.0.b"])
        P.n_wa, P.n_ba = pk.mat(nw["alpha.w"], rows=Wp), pk.vec(nw["alpha.b"])
        P.n_wrgb, P.n_brgb = pk.mat(nw["rgb.w"], rows=Hp), pk.vec(nw["rgb.b"])

        # the fused kernels find layer l's bias l widths past the first
        assert L.o_b == [L.o_b[0] + l * Wp0 for l in range(oracle.depth)]
        assert L.n_b == [L.n_b[0] + l * Wp for l in range(nerf.depth)]
        P.o_b0, P.n_b0 = L.o_b[0], L.n_b[0]
        P.skip_bits = sum(1 << (i - 1) for i in range(1, min(nerf.depth, FUSED_DEPTH))
                          if L.n_wx[i] >= 0)
        P.S, P.D, P.in0, P.in1 = S, D, in0, in1
        P.fd0, P.fp0, P.fp1, P.fd1 = fd0, fp0, fp1, fd1
        P.depth0, P.depth1 = oracle.depth, nerf.depth
        dr = sc.depth_range_warped
        if rt.z_no_range:
            P.z_mode = 0
        elif sc.depth_transform.name == "log":
            P.z_mode, P.z_a, P.z_b = 1, (dr[1] - dr[0]) + 1.0, dr[0]
        elif sc.depth_transform.name == "linear":
            P.z_mode, P.z_a, P.z_b = 2, dr[1] - dr[0], dr[0]
        else:
            P.z_mode = 0
        P.ndc = int(rt.use_ndc)
        if rt.use_ndc:
            if not (sc.w > 0 and sc.h > 0):
                raise ValueError("NDC export needs the training resolution "
                                 "(megakernel3.py:297 asserts the same)")
            P.ndc_wf = -1.0 / (sc.w / (2.0 * sc.focal))
            P.ndc_hf = -1.0 / (sc.h / (2.0 * sc.focal))
        P.norm_none = int(rt.norm_name in ("None", "none"))
        # as the plain version's composite: any other value premultiplies nothing
        P.acc_mode = {"alpha": 1, "weights": 2}.get(rt.accumulation_mult, 0)
        P.bf16 = int(bf16)
        P.threshold = rt.threshold
        P.radius2 = sc.view_cell_radius ** 2
        P.sqrt_max_depth = math.sqrt(sc.depth_max)
        P.center[:] = [float(c) for c in sc.view_cell_center]
        self.params = P

        wdtype = torch.bfloat16 if P.bf16 else torch.float32
        dev = renderer.device
        self.weights = torch.from_numpy(np.concatenate(pk.w)).to(dev, wdtype)
        self.biases = torch.from_numpy(np.concatenate(pk.b)).to(dev)
        # the per-layer table the kernels read (MkParams::lt)
        self.table = torch.tensor(L.o_w + L.n_w + L.n_wx, dtype=torch.int64, device=dev)

    def to(self, device):
        """This wrapper with its packed weights on ``device`` (itself where
        they are there already): a frame sharded over devices launches one
        per device. The plain version stays on the renderer's device."""
        device = torch.device(device)
        if device == self.weights.device:
            return self
        out = copy.copy(self)
        out.weights, out.biases, out.table = (t.to(device) for t in (self.weights, self.biases,
                                                                     self.table))
        return out

    def plain(self, dirs, pose, rot):
        """The plain PyTorch version: the renderer's compacted path."""
        return self.renderer.render_rays(pose, rot, dirs, compaction=True)

    def __call__(self, dirs, pose, rot, stages: int = 3):
        """dirs (B, 3) f32 camera-space unit dirs; pose (3,); rot (3, 3)
        camera-to-world. Returns (rgb (B, 3) f32, counts (B,) int32).
        stages < 3 stops the kernel early for profiling (1: front only,
        2: + shading), leaving later outputs unwritten."""
        if dirs.device.type == "cpu":
            return self.plain(dirs, torch.as_tensor(pose, dtype=torch.float32),
                              torch.as_tensor(rot, dtype=torch.float32))
        out = self._launch(dirs, pose, rot, stages)
        return out[-1], out[-2]

    def front(self, dirs, pose, rot):
        """The kernel's front half alone, on CUDA tensors: the shading rays'
        origins and directions (B, 3), each slot's depth and oracle value
        (B, S) and the counts (B,). A ray's live slots come first, in
        ascending bin order."""
        if dirs.device.type != "cuda":
            raise ValueError("front runs the kernel: dirs must be a CUDA tensor")
        return self._launch(dirs, pose, rot, 1)[:5]

    def _launch(self, dirs, pose, rot, stages):
        """One call: the front, the shade and the composite (up to
        ``stages``), each fused or wide; returns (o_sh, d_sh, zbuf, pbuf,
        counts, rgb)."""
        if dirs.device.type != "cuda":
            raise ValueError(f"unsupported device {dirs.device}")
        if dirs.dtype != torch.float32 or dirs.ndim != 2 or dirs.shape[1] != 3 \
                or not dirs.is_contiguous():
            raise ValueError("dirs must be a contiguous (B, 3) float32 tensor")
        if self.weights.device != dirs.device:
            raise ValueError(f"weights on {self.weights.device}, dirs on {dirs.device}")
        if stages not in (1, 2, 3):
            raise ValueError(f"stages must be 1, 2 or 3, got {stages}")
        dev = dirs.device
        pose = torch.as_tensor(pose, dtype=torch.float32).to(dev).contiguous().reshape(3)
        rot = torch.as_tensor(rot, dtype=torch.float32).to(dev).contiguous().reshape(3, 3)
        B, S = dirs.shape[0], self.params.S
        P = MkParams.from_buffer_copy(self.params)
        P.B, P.lt = B, self.table.data_ptr()
        P.shade_blocks = torch.cuda.get_device_properties(dev).multi_processor_count

        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        o_sh, d_sh = torch.empty((B, 3), **f32), torch.empty((B, 3), **f32)
        zbuf, pbuf = torch.empty((B, S), **f32), torch.empty((B, S), **f32)
        counts = torch.empty((B,), **i32)
        rows = counter = None  # K1's compact row list and its length
        if not self.DENSE:
            rows, counter = torch.empty((B * S,), **i32), torch.empty((1,), **i32)
        raw = torch.empty((B, S, 4), **f32)
        rgb = torch.empty((B, 3), **f32)
        bufs = (o_sh, d_sh, zbuf, pbuf, counts, rows, counter, raw, rgb)

        W0, W = self.widths
        if not (self.front_wide or self.shade_wide) and W0 == W:
            self._fused(W, P, 1, stages, dirs, pose, rot, bufs)  # as one library
        else:
            if self.front_wide:
                self._front_wide(P, dirs, pose, rot, bufs)
            else:
                self._fused(W0, P, 1, 1, dirs, pose, rot, bufs)
            if stages >= 2 and self.shade_wide:
                self._shade_wide(P, dev, bufs, stages)
            elif stages >= 2:
                self._fused(W, P, 2, stages, dirs, pose, rot, bufs)
        type(self).launches += 1
        return o_sh, d_sh, zbuf, pbuf, counts, rgb

    def _fused(self, width, P, first, stages, dirs, pose, rot, bufs):
        """The fused kernels of the library at ``width``, stages first..stages."""
        P = MkParams.from_buffer_copy(P)
        P.from_stage, P.stages = first, stages
        dev = dirs.device
        launch = _library(self.SOURCE, self.SYMBOL, width)
        rc = launch(
            dev.index if dev.index is not None else torch.cuda.current_device(),
            ctypes.byref(P), *(None if t is None else t.data_ptr() for t in (
                dirs, pose, rot, self.weights, self.biases) + bufs),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.SYMBOL} failed: CUDA error {rc}")

    def _w(self, off):
        return self.weights.data_ptr() + off * self.weights.element_size()

    def _b(self, off):
        return self.biases.data_ptr() + off * 4

    def _front_wide(self, P, dirs, pose, rot, bufs):
        """The front on the wide path: ray setup and encode, the oracle
        layer by layer (the last into fp32 logits), the select."""
        o_sh, d_sh, zbuf, pbuf, counts, rows, counter, _, _ = bufs
        dev, L, W0 = dirs.device, self.layers, self.padded[0]
        bf = bool(P.bf16)
        adt = torch.bfloat16 if bf else torch.float32
        R = wide.pad_rows(P.B)
        x = torch.empty(R * P.in0, dtype=adt, device=dev)
        wide.rows_kernel("front_prep", dev, P, dirs, pose, rot, o_sh, d_sh, x, R)
        logits = torch.empty((R, 128), dtype=torch.float32, device=dev)
        h = [torch.empty(R * W0, dtype=adt, device=dev) for _ in range(min(2, P.depth0 - 1))]
        a, k = x, P.in0
        for l in range(P.depth0):
            last = l == P.depth0 - 1
            n, out = (128, logits) if last else (W0, h[l % 2])
            if bf:
                wide.gemm(dev, a, k // TC_KC, self._w(L.o_w[l]), n, R, bias=self._b(L.o_b[l]),
                          relu=not last, out=None if last else out, f32=logits if last else None,
                          ldf=128, f32_cols=128)
            else:
                wide.gemm_f32(dev, a, k, self._w(L.o_w[l]), n, R, self._b(L.o_b[l]),
                              relu=not last, out=out)
            a, k = out, W0
        wide.rows_kernel("select", dev, P, int(self.DENSE), logits, zbuf, pbuf, counts, rows,
                         counter)

    def _live_rows(self, counter, total):
        """The sample rows the wide shade covers: K1's live count, read once
        a frame (one synchronising read), so that it launches the chunks of
        the live rows only; K2 shades every slot, total."""
        return total if self.DENSE else int(counter.item())

    def _shade_wide(self, P, dev, bufs, stages):
        """The shade on the wide path, CHUNK sample rows at a time (K1: the
        live rows; K2: all B * S): encode, the trunk, the feature layer, the
        alpha head, the views layer and the rgb head layer by layer; then
        the composite. The kernels bound their rows by the count on the
        device as well."""
        o_sh, d_sh, zbuf, pbuf, counts, rows, counter, raw, rgb = bufs
        L, (_, W, H) = self.layers, self.padded
        bf, kx = bool(P.bf16), P.in1 // TC_KC
        adt = torch.bfloat16 if bf else torch.float32
        total = self._live_rows(counter, P.B * P.S)
        C = min(CHUNK, wide.pad_rows(max(total, 1)))
        x = torch.empty(C * P.in1, dtype=adt, device=dev)
        h = [torch.empty(C * W, dtype=adt, device=dev) for _ in range(2)]
        alpha = torch.empty(C, dtype=torch.float32, device=dev)

        def layer(a, k, w, n, bias, relu, out, wx=-1):
            # [a | x where wx >= 0] @ w + bias, over the chunk's rows; bf16
            # streams a layer's two inputs as one product from w, fp32 keeps
            # x's rows a matrix of their own at wx
            if bf:
                wide.gemm(dev, a, k // TC_KC, self._w(w), n, m, a1=x if wx >= 0 else None,
                          kc1=kx if wx >= 0 else 0, bias=self._b(bias), relu=relu, out=out,
                          count=counter, base=base)
            else:
                wide.gemm_f32(dev, a, k, self._w(w), n, m, self._b(bias), relu=relu, out=out,
                              a1=x if wx >= 0 else None, k1=P.in1 if wx >= 0 else 0,
                              w1=self._w(wx) if wx >= 0 else None, count=counter, base=base)

        def head(which, act, F, w, b, out=None):
            wide.rows_kernel("head", dev, which, int(bf), int(bf), act, F, self._w(w), self._b(b),
                             alpha, rows, counter, base, m, out)
        for base in range(0, total, C):
            m = min(C, total - base)
            wide.rows_kernel("shade_prep", dev, P, int(self.DENSE), o_sh, d_sh, zbuf, rows, counter,
                             base, wide.pad_rows(m), x)
            a, k = x, P.in1
            for l in range(P.depth1):
                layer(a, k, L.n_w[l], W, L.n_b[l], True, h[l % 2], L.n_wx[l])
                a, k = h[l % 2], W
            t, f = h[(P.depth1 - 1) % 2], h[P.depth1 % 2]
            layer(t, W, P.n_wf, W, P.n_bf, False, f)
            head(0, t, W, P.n_wa, P.n_ba)
            layer(f, W, P.n_wvf, H, P.n_bv, True, t, wx=P.n_wvd)  # [feature, x]
            head(1, t, H, P.n_wrgb, P.n_brgb, raw)
        if stages >= 3:
            wide.rows_kernel("composite", dev, P, int(self.DENSE), raw, pbuf, counts, rgb)


def _library(source, symbol, width):
    """The launch function ``symbol`` of ``source``'s library at an MLP
    width, bound and checked against this MkParams layout."""
    lib = build.load(library(source, width))
    if not getattr(lib, "_mk_bound", False):
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(MkParams)] + [ctypes.c_void_p] * 15
        fn.restype = ctypes.c_int
        lib.mk_struct_size.argtypes = []
        lib.mk_struct_size.restype = ctypes.c_int
        if lib.mk_struct_size() != ctypes.sizeof(MkParams):
            raise RuntimeError(f"MkParams layout differs: C {lib.mk_struct_size()} "
                               f"bytes, ctypes {ctypes.sizeof(MkParams)} bytes")
        lib.mk_width.restype = ctypes.c_int
        if lib.mk_width() != width:
            raise RuntimeError(f"{library(source, width)} is built for width {lib.mk_width()}")
        lib._mk_bound = True
    return getattr(lib, symbol)
