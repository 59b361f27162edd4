"""K1: the compacted adaptive frame renderer, as one hand-written CUDA kernel
source (``csrc/megakernel_compact.cu``) beside its plain PyTorch version.

Replaces ``adanerf_tpu/ops/pallas/megakernel3.py::make_megakernel_compact``.
``MegakernelCompact(renderer)`` packs the renderer's two MLPs once; calling
it renders a batch of rays to ``(rgb (B, 3), counts (B,))``:

  * on a CUDA tensor it launches the kernel (three launches on the current
    stream, no host synchronisation) and counts the call in ``launches``;
  * on a CPU tensor it runs the plain version, ``plain``, which is the
    renderer's own PyTorch path (``adanerf_tpu_torch/realtime.py``).

It takes MLPs of one width, 128, 256, 384 or 512 (``WIDTHS``; one library
each, ``library``); ``refusal`` says why it does not take an export, and
the viewer's default route asks it.

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

import numpy as np
import torch

from . import build

SOURCE = "megakernel_compact.cu"
MAXL = 16   # most layers per MLP (MkParams arrays)
WIDTHS = (128, 256, 384, 512)  # hidden widths the kernels are built for
ROADMAP = "ROADMAP Queue 2, K1/K2 widths above 512"
ALIGN = 64   # element alignment of each packed matrix

_ll16 = ctypes.c_longlong * MAXL


class MkParams(ctypes.Structure):
    """Mirror of ``struct MkParams`` in ``csrc/megakernel.cuh``, field for
    field."""
    _fields_ = [("o_w", _ll16), ("o_b", _ll16),
                ("n_w", _ll16), ("n_wx", _ll16), ("n_b", _ll16)] + \
        [(k, ctypes.c_longlong) for k in ("n_wa", "n_ba", "n_wf", "n_bf", "n_wvf",
                                          "n_wvd", "n_bv", "n_wrgb", "n_brgb")] + \
        [(k, ctypes.c_int) for k in ("B", "S", "D", "in0", "in1", "fd0", "fp0",
                                     "fp1", "fd1", "depth0", "depth1", "skip_mask",
                                     "z_mode", "ndc", "norm_none", "acc_mode",
                                     "bf16", "stages", "shade_blocks")] + \
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


def stream_plan(P, front: bool, width: int = 256):
    """[(kc0, kc1, n)] for each weight layer of a bf16 stream, as
    ``csrc/megakernel.cuh::tc_plan`` walks it: kc0 chunks of the layer's
    first input, kc1 of the encoded input x (a NeRF skip layer, the views
    layer), n output columns (a layer wider than 256 comes pass by pass,
    ``passes``: each pass's kc0 + kc1 chunks). The front walks the oracle,
    the shade the NeRF trunk, the feature layer and the views layer (width
    / 2 wide)."""
    W = width
    if front:
        return [(P.in0 // TC_KC if l == 0 else W // TC_KC, 0,
                 128 if l == P.depth0 - 1 else W) for l in range(P.depth0)]
    plan = [(P.in1 // TC_KC, 0, W)]
    for l in range(1, P.depth1):
        plan.append((W // TC_KC, P.in1 // TC_KC if (P.skip_mask >> (l - 1)) & 1 else 0, W))
    return plan + [(W // TC_KC, 0, W), (W // TC_KC, P.in1 // TC_KC, W // 2)]


def stream_bytes(P, front: bool, width: int = 256) -> int:
    """Bytes of one walk of a bf16 stream: what TC_ROWS_PER_WALK rows read
    from L2."""
    return sum((kc0 + kc1) * n * TC_KC * 2 for kc0, kc1, n in stream_plan(P, front, width))


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


def refusal(renderer):
    """Why K1 (and K2, which adds refusals of its own) does not take this
    renderer's export, or None when it does. The wrapper raises it; the
    viewer's default route asks it to choose between K1 and the plain
    path."""
    rt, cfg = renderer, renderer.config
    oracle, nerf = rt.oracle, rt.nerf
    if renderer.dtype not in (None, torch.bfloat16):
        return f"kernel precision is fp32 or bf16, got {renderer.dtype}"
    if list(cfg.posEnc) != ["nerf", "nerf"]:
        return f"kernel implements the nerf encoding, got {cfg.posEnc}"
    if not rt.threshold > 0.0:
        return (f"kernel needs an adaptive model (adaptiveSamplingThreshold > 0; this one has "
                f"threshold {rt.threshold})")
    D, S = oracle.n_out, rt.max_samples
    if D % 32 or D > 128 or not 1 <= S <= 16:
        return f"kernel needs D in 32..128 step 32 and S <= 16 (D={D}, S={S})"
    if rt.norm_name not in ("InverseSqrtDistCentered", "None", "none"):
        # an absent key means MaxDepth, which the kernel does not implement
        return (f"kernel supports rayMarchNormalization[1] in "
                f"('InverseSqrtDistCentered', 'None'); got {rt.norm_name!r}")
    if rt.accumulation_mult not in (None, "alpha", "weights"):
        return f"unknown accumulationMult {rt.accumulation_mult!r}"
    if nerf.width > WIDTHS[-1] and nerf.width % 128 == 0:
        return (f"MLP width {nerf.width}: the kernels are built for widths up to "
                f"{WIDTHS[-1]} ({ROADMAP})")
    if nerf.width not in WIDTHS:
        return f"kernel needs an MLP width in {WIDTHS}, got {nerf.width}"
    if oracle.width != nerf.width:
        return (f"kernel needs the oracle as wide as the NeRF (oracle {oracle.width}, "
                f"NeRF {nerf.width}; {ROADMAP} and mixed widths)")
    if oracle.skip or oracle.depth > MAXL or nerf.depth > MAXL:
        return f"kernel needs a skip-free oracle and MLPs of <= {MAXL} layers"
    if oracle.depth < 2:
        return "kernel needs an oracle of at least 2 layers"
    fp0, fd0 = [int(x) for x in cfg.posEncArgs[0].split('-')]
    fp1, fd1 = [int(x) for x in cfg.posEncArgs[1].split('-')]
    in_ch, in_views = nerf.input_ch, nerf.input_ch_views
    if in_ch != 6 * fp1 + 3 or in_views != 6 * fd1 + 3 \
            or oracle.n_in != 6 * (fp0 + fd0) + 6:
        return "MLP input widths do not match posEncArgs"
    if oracle.n_in > 128 or in_ch + in_views > 128:
        return "encoded inputs wider than 128 columns"
    return None


class MegakernelCompact:
    """K1 wrapper around a ``RealtimeRenderer`` (the plain version).

    ``MegakernelCompact.launches`` counts kernel launches over all instances,
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
        W = self.width = nerf.width
        D, S = oracle.n_out, rt.max_samples
        fp0, fd0 = [int(x) for x in cfg.posEncArgs[0].split('-')]
        fp1, fd1 = [int(x) for x in cfg.posEncArgs[1].split('-')]
        in_ch, in_views = nerf.input_ch, nerf.input_ch_views
        bf16 = renderer.dtype is torch.bfloat16
        # the tensor-core layer takes K in 64-column blocks
        in0, in1 = (_pad(n, TC_KC if bf16 else 32) for n in (oracle.n_in, in_ch + in_views))

        P = MkParams()
        pk = _Packer()
        # both precisions pack the matrices in stream_plan's order: the
        # oracle, then the NeRF trunk (a skip layer's h rows before its x
        # rows), the feature and views layers, then the row-major heads. bf16
        # writes each as stream chunks, which its kernels walk from o_w[0]
        # and n_w[0]; fp32 keeps them row-major, read by their offsets
        mat = (lambda a, rows=None, cols=None: pk.layer([(a, rows)], cols or a.shape[1])[0]) \
            if bf16 else pk.mat
        ow = _numpy_state(oracle)
        for i in range(oracle.depth):
            last = i == oracle.depth - 1
            P.o_w[i] = mat(ow[f"{i}.w"], rows=in0 if i == 0 else None,
                           cols=128 if last else None)
            P.o_b[i] = pk.vec(ow[f"{i}.b"], 128 if last else None)
        nw = _numpy_state(nerf)
        P.n_w[0] = mat(nw["pts.0.w"], rows=in1)
        P.n_b[0] = pk.vec(nw["pts.0.b"])
        skip_mask = 0
        for i in range(1, nerf.depth):
            w = nw[f"pts.{i}.w"]
            skip = (i - 1) in nerf.skips  # input is [input_pts, h]
            skip_mask |= skip << (i - 1)
            if skip and bf16:  # [h, x] pass by pass
                P.n_w[i], P.n_wx[i] = pk.layer([(w[in_ch:], None), (w[:in_ch], in1)], W)
            else:
                P.n_w[i] = mat(w[in_ch:] if skip else w)
                if skip:
                    P.n_wx[i] = mat(w[:in_ch], rows=in1)
            P.n_b[i] = pk.vec(nw[f"pts.{i}.b"])
        P.n_wf, P.n_bf = mat(nw["feature.w"]), pk.vec(nw["feature.b"])
        wv = nw["views.0.w"]  # input is [feature W | dirs in_views]
        P.n_wvf = mat(wv[:W])
        wvd = np.zeros((in1, W // 2), np.float32)
        wvd[in_ch:in_ch + in_views] = wv[W:]
        P.n_wvd = mat(wvd)
        P.n_bv = pk.vec(nw["views.0.b"])
        P.n_wa, P.n_ba = pk.mat(nw["alpha.w"]), pk.vec(nw["alpha.b"])
        P.n_wrgb, P.n_brgb = pk.mat(nw["rgb.w"]), pk.vec(nw["rgb.b"])

        P.S, P.D, P.in0, P.in1 = S, D, in0, in1
        P.fd0, P.fp0, P.fp1, P.fd1 = fd0, fp0, fp1, fd1
        P.depth0, P.depth1, P.skip_mask = oracle.depth, nerf.depth, skip_mask
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
                raise ValueError("NDC export needs the training resolution")
            P.ndc_wf = -1.0 / (sc.w / (2.0 * sc.focal))
            P.ndc_hf = -1.0 / (sc.h / (2.0 * sc.focal))
        P.norm_none = int(rt.norm_name in ("None", "none"))
        P.acc_mode = {None: 0, "alpha": 1, "weights": 2}[rt.accumulation_mult]
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

    def to(self, device):
        """This wrapper with its packed weights on ``device`` (itself where
        they are there already): a frame sharded over devices launches one
        per device. The plain version stays on the renderer's device."""
        device = torch.device(device)
        if device == self.weights.device:
            return self
        out = copy.copy(self)
        out.weights, out.biases = self.weights.to(device), self.biases.to(device)
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
        """One launch; returns (o_sh, d_sh, zbuf, pbuf, counts, rgb)."""
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
        P.B, P.stages = B, stages
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

        launch = _library(self.SOURCE, self.SYMBOL, self.width)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            dev.index if dev.index is not None else torch.cuda.current_device(),
            ctypes.byref(P), *(None if t is None else t.data_ptr() for t in (
                dirs, pose, rot, self.weights, self.biases, o_sh, d_sh, zbuf, pbuf,
                counts, rows, counter, raw, rgb)), stream)
        if rc != 0:
            raise RuntimeError(f"{self.SYMBOL} failed: CUDA error {rc}")
        type(self).launches += 1
        return o_sh, d_sh, zbuf, pbuf, counts, rgb


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
