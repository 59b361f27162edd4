"""K1: the compacted adaptive frame renderer, as one hand-written CUDA kernel
source (``csrc/megakernel_compact.cu``) beside its plain PyTorch version.

Replaces ``adanerf_tpu/ops/pallas/megakernel3.py::make_megakernel_compact``.
``MegakernelCompact(renderer)`` packs the renderer's two MLPs once; calling
it renders a batch of rays to ``(rgb (B, 3), counts (B,))``:

  * on a CUDA tensor it launches the kernel (three launches on the current
    stream, no host synchronisation) and counts the call in ``launches``;
  * on a CPU tensor it runs the plain version, ``plain``, which is the
    renderer's own PyTorch path (``adanerf_tpu_torch/realtime.py``).

The kernel takes the renderer's precision: fp32 weights when
``renderer.dtype`` is None, bf16 weights and bf16-rounded matmul inputs
with fp32 accumulation when it is ``torch.bfloat16``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import build

SOURCE = "megakernel_compact.cu"
MAXL = 16   # most layers per MLP (MkParams arrays)
WIDTH = 256  # hidden width the kernel is written for
ALIGN = 64   # element alignment of each packed matrix

_ll16 = ctypes.c_longlong * MAXL


class MkParams(ctypes.Structure):
    """Mirror of ``struct MkParams`` in the CUDA source, field for field."""
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


def _pad32(n: int) -> int:
    return 32 * math.ceil(n / 32)


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


class MegakernelCompact:
    """K1 wrapper around a ``RealtimeRenderer`` (the plain version).

    ``MegakernelCompact.launches`` counts kernel launches over all instances,
    so a caller can show that a run went through the kernel."""

    launches = 0

    def __init__(self, renderer):
        self.renderer = renderer
        rt, cfg, sc = renderer, renderer.config, renderer.scene
        oracle, nerf = rt.oracle, rt.nerf
        if renderer.dtype not in (None, torch.bfloat16):
            raise ValueError(f"kernel precision is fp32 or bf16, got {renderer.dtype}")
        if oracle.width != WIDTH or nerf.width != WIDTH:
            raise ValueError(f"kernel needs width {WIDTH} MLPs")
        if oracle.skip or oracle.depth > MAXL or nerf.depth > MAXL:
            raise ValueError("kernel needs a skip-free oracle of <= 16 layers")
        if list(cfg.posEnc) != ["nerf", "nerf"]:
            raise ValueError(f"kernel implements the nerf encoding, got {cfg.posEnc}")
        if not rt.threshold > 0.0:
            raise ValueError("kernel needs an adaptive model (adaptiveSamplingThreshold > 0)")
        D, S = oracle.n_out, rt.max_samples
        if D % 32 or D > 128 or not 1 <= S <= 16:
            raise ValueError(f"kernel needs D in 32..128 step 32 and S <= 16 (D={D}, S={S})")
        if rt.norm_name not in ("InverseSqrtDistCentered", "None", "none"):
            # an absent key means MaxDepth, which the kernel does not implement
            raise ValueError(f"kernel supports rayMarchNormalization[1] in "
                             f"('InverseSqrtDistCentered', 'None'); got {rt.norm_name!r}")
        if rt.accumulation_mult not in (None, "alpha", "weights"):
            raise ValueError(f"unknown accumulationMult {rt.accumulation_mult!r}")
        fp0, fd0 = [int(x) for x in cfg.posEncArgs[0].split('-')]
        fp1, fd1 = [int(x) for x in cfg.posEncArgs[1].split('-')]
        in_ch, in_views = nerf.input_ch, nerf.input_ch_views
        if in_ch != 6 * fp1 + 3 or in_views != 6 * fd1 + 3 \
                or oracle.n_in != 6 * (fp0 + fd0) + 6:
            raise ValueError("MLP input widths do not match posEncArgs")
        in0, in1 = _pad32(oracle.n_in), _pad32(in_ch + in_views)
        if in0 > 128 or in1 > 128:
            raise ValueError("encoded inputs wider than 128 columns")

        P = MkParams()
        pk = _Packer()
        ow = _numpy_state(oracle)
        for i in range(oracle.depth):
            last = i == oracle.depth - 1
            P.o_w[i] = pk.mat(ow[f"{i}.w"], rows=in0 if i == 0 else None,
                              cols=128 if last else None)
            P.o_b[i] = pk.vec(ow[f"{i}.b"], 128 if last else None)
        nw = _numpy_state(nerf)
        P.n_w[0] = pk.mat(nw["pts.0.w"], rows=in1)
        P.n_b[0] = pk.vec(nw["pts.0.b"])
        skip_mask = 0
        for i in range(1, nerf.depth):
            w = nw[f"pts.{i}.w"]
            if (i - 1) in nerf.skips:  # input is [input_pts, h]
                skip_mask |= 1 << (i - 1)
                P.n_wx[i] = pk.mat(w[:in_ch], rows=in1)
                w = w[in_ch:]
            P.n_w[i] = pk.mat(w)
            P.n_b[i] = pk.vec(nw[f"pts.{i}.b"])
        P.n_wf, P.n_bf = pk.mat(nw["feature.w"]), pk.vec(nw["feature.b"])
        P.n_wa, P.n_ba = pk.mat(nw["alpha.w"]), pk.vec(nw["alpha.b"])
        wv = nw["views.0.w"]  # input is [feature W | dirs in_views]
        P.n_wvf = pk.mat(wv[:WIDTH])
        wvd = np.zeros((in1, WIDTH // 2), np.float32)
        wvd[in_ch:in_ch + in_views] = wv[WIDTH:]
        P.n_wvd = pk.mat(wvd)
        P.n_bv = pk.vec(nw["views.0.b"])
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
        P.bf16 = int(renderer.dtype is torch.bfloat16)
        P.threshold = rt.threshold
        P.radius2 = sc.view_cell_radius ** 2
        P.sqrt_max_depth = math.sqrt(sc.depth_max)
        P.center[:] = [float(c) for c in sc.view_cell_center]
        self.params = P

        wdtype = torch.bfloat16 if P.bf16 else torch.float32
        dev = renderer.device
        self.weights = torch.from_numpy(np.concatenate(pk.w)).to(dev, wdtype)
        self.biases = torch.from_numpy(np.concatenate(pk.b)).to(dev)

    def plain(self, dirs, pose, rot):
        """The plain PyTorch version: the renderer's compacted path."""
        return self.renderer.render_rays(pose, rot, dirs)

    def __call__(self, dirs, pose, rot, stages: int = 3):
        """dirs (B, 3) f32 camera-space unit dirs; pose (3,); rot (3, 3)
        camera-to-world. Returns (rgb (B, 3) f32, counts (B,) int32).
        stages < 3 stops the kernel early for profiling (1: front only,
        2: + shading), leaving later outputs unwritten."""
        if dirs.device.type == "cpu":
            return self.plain(dirs, torch.as_tensor(pose, dtype=torch.float32),
                              torch.as_tensor(rot, dtype=torch.float32))
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
        counts, rows = torch.empty((B,), **i32), torch.empty((B * S,), **i32)
        counter = torch.empty((1,), **i32)
        raw = torch.empty((B, S, 4), **f32)
        rgb = torch.empty((B, 3), **f32)

        lib = _library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mk_compact_launch(
            dev.index if dev.index is not None else torch.cuda.current_device(),
            ctypes.byref(P), *(t.data_ptr() for t in (
                dirs, pose, rot, self.weights, self.biases, o_sh, d_sh, zbuf, pbuf,
                counts, rows, counter, raw, rgb)), stream)
        if rc != 0:
            raise RuntimeError(f"megakernel_compact launch failed: CUDA error {rc}")
        MegakernelCompact.launches += 1
        return rgb, counts


def _library():
    lib = build.load(SOURCE)
    if not getattr(lib, "_mk_bound", False):
        lib.mk_compact_launch.argtypes = [ctypes.c_int, ctypes.POINTER(MkParams)] + \
            [ctypes.c_void_p] * 15
        lib.mk_compact_launch.restype = ctypes.c_int
        lib.mk_struct_size.argtypes = []
        lib.mk_struct_size.restype = ctypes.c_int
        if lib.mk_struct_size() != ctypes.sizeof(MkParams):
            raise RuntimeError(f"MkParams layout differs: C {lib.mk_struct_size()} "
                               f"bytes, ctypes {ctypes.sizeof(MkParams)} bytes")
        lib._mk_bound = True
    return lib
