"""The wide path of the frame kernels (K1, K2) and of K3: the bindings of
``csrc/wide.cu``, one library for every width.

The fused kernels hold a tile's activations in shared memory; they take
MLPs of 128 and 256 columns (and K3 at most 128 encoded input columns).
The wide path takes every other shape, 384 and 512 columns too, where it
measured faster than the fused kernels' two wgmma passes a layer. It runs
the layers one at a time, each a hand-written GEMM with a fused epilogue
(``gemm``: a persistent wgmma GEMM on bf16; ``gemm_f32``: fp32 FMAs), the
activations between layers in device memory, and the per-row work in small
kernels of its own (``rows_kernel``). ``megakernel_compact.py`` and
``nerf_train.py`` launch them layer by layer where a network's shape asks
for it; their plain versions are the fused kernels' own.

Layouts: a bf16 activation matrix of F columns (F a multiple of 64) is
stored in mlp_wgmma.cuh's tile layout, per 64-row tile F / 64 swizzled
64 x 64 blocks; fp32 ones are row-major. A GEMM's weights are the packed
stream of its product, pass by pass, as the fused kernels read them.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "wide.cu"
ROWS = 128  # rows of a GEMM tile: activation buffers hold a multiple of it
gemm_launches = 0  # wd_gemm launches in this process (gemm)


class WdGemm(ctypes.Structure):
    """Mirror of ``struct WdGemm`` in ``csrc/wide.cu``, field for field."""
    _fields_ = [(k, ctypes.c_void_p) for k in ("a0", "a1", "w", "bias", "out", "st", "f32",
                                               "mask", "bp", "ga", "wa", "count")] + \
        [(k, ctypes.c_int) for k in ("kc0", "kc1", "n", "rows", "base", "relu", "ldf",
                                     "f32_cols", "f32_add", "ldbp")]


class WdF32(ctypes.Structure):
    """Mirror of ``struct WdF32`` in ``csrc/wide.cu``."""
    _fields_ = [(k, ctypes.c_void_p) for k in ("a0", "a1", "w0", "w1", "bias", "out",
                                               "count")] + \
        [(k, ctypes.c_int) for k in ("k0", "k1", "n", "rows", "base", "relu")]


def pad_rows(n: int) -> int:
    """Rows of an activation buffer for n rows: a multiple of ROWS."""
    return ROWS * -(-n // ROWS)


def _ptr(t):
    """A tensor's device address, an int as it is, None for null."""
    if t is None or isinstance(t, int):
        return t
    return t.data_ptr()


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def _lib():
    lib = build.load(SOURCE)
    if not getattr(lib, "_wd_bound", False):
        from .megakernel_compact import MkParams
        vp, i = ctypes.c_void_p, ctypes.c_int
        sigs = {"wd_gemm_launch": [i, ctypes.POINTER(WdGemm), vp],
                "wd_gemm_f32_launch": [i, ctypes.POINTER(WdF32), vp],
                "wd_front_prep_launch": [i, ctypes.POINTER(MkParams)] + [vp] * 6 + [i, vp],
                "wd_select_launch": [i, ctypes.POINTER(MkParams), i] + [vp] * 7,
                "wd_shade_prep_launch": [i, ctypes.POINTER(MkParams), i] + [vp] * 5 +
                                        [i, i, vp, vp],
                "wd_head_launch": [i, i, i, i, vp, i, vp, vp, vp, vp, vp, i, i, vp, vp],
                "wd_composite_launch": [i, ctypes.POINTER(MkParams), i] + [vp] * 5,
                "wd_load_x_launch": [i, vp, i, i, i, i, vp, vp, vp],
                "wd_head_grads_launch": [i, vp, vp, i, i, i, vp, vp, i, i, i, i, i, vp],
                "wd_ghv_launch": [i, vp, vp, i, i, i, vp, vp, vp, i, i, vp, vp],
                "wd_struct_size": [i]}
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        for which, cls in ((0, MkParams), (1, WdGemm), (2, WdF32)):
            if lib.wd_struct_size(which) != ctypes.sizeof(cls):
                raise RuntimeError(f"{cls.__name__} layout differs: C {lib.wd_struct_size(which)} "
                                   f"bytes, ctypes {ctypes.sizeof(cls)} bytes")
        lib._wd_bound = True
    return lib


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _index(dev):
    return dev.index if dev.index is not None else torch.cuda.current_device()


def gemm(dev, a0, kc0, w, n, rows, a1=None, kc1=0, bias=None, relu=False, out=None, st=None,
         f32=None, ldf=0, f32_cols=0, f32_add=False, mask=None, bp=None, ldbp=0, ga=None,
         wa=None, count=None, base=0):
    """One bf16 layer on the tensor cores (``wd_gemm``): the epilogue of
    ``[a0 | a1] @ w`` over ``rows`` rows (or the device count past base, at
    most rows), n columns; see ``struct WdGemm`` for each argument. Tensors
    or device addresses."""
    global gemm_launches
    G = WdGemm(*(_ptr(t) for t in (a0, a1, w, bias, out, st, f32, mask, bp, ga, wa, count)),
               kc0, kc1, n, rows, base, int(relu), ldf, f32_cols, int(f32_add), ldbp)
    _check(_lib().wd_gemm_launch(_index(dev), ctypes.byref(G), _stream(dev)), "wd_gemm")
    gemm_launches += 1


def gemm_f32(dev, a0, k0, w0, n, rows, bias, relu=False, out=None, a1=None, k1=0, w1=None,
             count=None, base=0):
    """One fp32 layer (``wd_gemm_f32``): out = act(a0 @ w0 + a1 @ w1 +
    bias), row-major."""
    G = WdF32(*(_ptr(t) for t in (a0, a1, w0, w1, bias, out, count)), k0, k1, n, rows, base,
              int(relu))
    _check(_lib().wd_gemm_f32_launch(_index(dev), ctypes.byref(G), _stream(dev)), "wd_gemm_f32")


def rows_kernel(name, dev, *args):
    """Launch one of wide.cu's per-row kernels, ``wd_<name>_launch``, with
    its arguments after the device index (tensors passed by address, a
    ctypes Structure by reference); the stream is the device's current
    one."""
    conv = [ctypes.byref(a) if isinstance(a, ctypes.Structure) else _ptr(a)
            if isinstance(a, torch.Tensor) or a is None else a for a in args]
    fn = getattr(_lib(), f"wd_{name}_launch")
    _check(fn(_index(dev), *conv, _stream(dev)), f"wd_{name}")
