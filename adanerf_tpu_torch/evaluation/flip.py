"""FLIP perceptual difference metric (Andersson et al., HPG 2020).

Counterpart of ``adanerf_tpu/evaluation/flip.py``, in torch on the given
device, in float32: opponent-space CSF filtering, Hunt-adjusted L*a*b*,
HyAB colour error with redistribution, and a Gaussian-derivative
edge/point feature error that exponent-modulates the colour error.
Channel-last (h, w, 3) images in [0, 1] sRGB; the convolutions are
``F.conv2d`` on replicate-padded inputs.

On CUDA, cuDNN may run float32 convolutions in TF32
(``torch.backends.cudnn.allow_tf32`` is True by default); ``flip_error_map``
turns TF32 off for its convolutions and colour-space products.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# D65 sRGB -> XYZ (row-major), the exact rational matrix of the sRGB spec
_A_XYZ = np.array([
    [10135552 / 24577794, 8788810 / 24577794, 4435075 / 24577794],
    [2613072 / 12288897, 8788810 / 12288897, 887015 / 12288897],
    [1425312 / 73733382, 8788810 / 73733382, 70074185 / 73733382],
], np.float64)
_A_XYZ_INV = np.linalg.inv(_A_XYZ)
_WHITE = _A_XYZ @ np.ones(3)  # reference illuminant = linrgb ones in XYZ

_QC, _QF, _PC, _PT = 0.7, 0.5, 0.4, 0.95


def default_pixels_per_degree(monitor_distance=0.7, monitor_width=0.7,
                              monitor_resolution_x=3840) -> float:
    return monitor_distance * (monitor_resolution_x / monitor_width) * (math.pi / 180)


def _const(a, like):
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


def srgb_to_linear(c):
    c = c.clamp(0.0, 1.0)
    return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def linear_to_xyz(c):
    return torch.einsum('ij,hwj->hwi', _const(_A_XYZ, c), c)


def xyz_to_linear(c):
    return torch.einsum('ij,hwj->hwi', _const(_A_XYZ_INV, c), c)


def xyz_to_ycxcz(c):
    n = c / _const(_WHITE, c)
    y = 116.0 * n[..., 1] - 16.0
    cx = 500.0 * (n[..., 0] - n[..., 1])
    cz = 200.0 * (n[..., 1] - n[..., 2])
    return torch.stack([y, cx, cz], dim=-1)


def ycxcz_to_xyz(c):
    y = (c[..., 0] + 16.0) / 116.0
    x = y + c[..., 1] / 500.0
    z = y - c[..., 2] / 200.0
    return torch.stack([x, y, z], dim=-1) * _const(_WHITE, c)


def xyz_to_lab(c):
    n = c / _const(_WHITE, c)
    delta = 6.0 / 29.0
    cbrt = torch.sign(n) * n.abs() ** (1.0 / 3.0)
    f = torch.where(n > 0.00885, cbrt, n / (3 * delta * delta) + 4.0 / 29.0)
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([l, a, b], dim=-1)


def _conv2d_replicate(img, kernel):
    """Depthwise 2D correlation with replicate padding.
    img: (h, w, C); kernel: (k, k) shared across channels."""
    r = kernel.shape[0] // 2
    x = img.permute(2, 0, 1)[:, None]                        # (C, 1, H, W)
    x = F.pad(x, (r, r, r, r), mode='replicate')
    return F.conv2d(x, kernel[None, None])[:, 0].permute(1, 2, 0)


def _csf_kernel(pixels_per_degree, a1, b1, a2, b2, radius):
    delta_x = 1.0 / pixels_per_degree
    rng = np.arange(-radius, radius + 1)
    x, y = np.meshgrid(rng, rng)
    z = (x * delta_x) ** 2 + (y * delta_x) ** 2
    g = a1 * np.sqrt(np.pi / b1) * np.exp(-np.pi ** 2 * z / b1) \
        + a2 * np.sqrt(np.pi / b2) * np.exp(-np.pi ** 2 * z / b2)
    return (g / g.sum()).astype(np.float32)


def _csf_filter_bank(pixels_per_degree):
    params = {"A": (1.0, 0.0047, 0.0, 1e-5),
              "RG": (1.0, 0.0053, 0.0, 1e-5),
              "BY": (34.1, 0.04, 13.5, 0.025)}
    max_b = max(max(p[1], p[3]) for p in params.values())
    radius = int(np.ceil(3 * np.sqrt(max_b / (2 * np.pi ** 2)) * pixels_per_degree))
    return {ch: _csf_kernel(pixels_per_degree, *p, radius)
            for ch, p in params.items()}, radius


def _spatial_filter(ycxcz, kernels):
    """CSF-filter each opponent channel, then clamp in linear RGB."""
    filtered = torch.stack([
        _conv2d_replicate(ycxcz[..., c:c + 1], _const(kernels[ch], ycxcz))[..., 0]
        for c, ch in enumerate(("A", "RG", "BY"))], dim=-1)
    return xyz_to_linear(ycxcz_to_xyz(filtered)).clamp(0.0, 1.0)


def hunt_adjust(lab):
    l = lab[..., 0:1]
    return torch.cat([l, 0.01 * l * lab[..., 1:3]], dim=-1)


def hyab(a, b):
    d = a - b
    return d[..., 0].abs() + torch.linalg.vector_norm(d[..., 1:3], dim=-1)


def _redistribute(p, cmax, pc=_PC, pt=_PT):
    pccmax = pc * cmax
    return torch.where(p < pccmax, (pt / pccmax) * p,
                       pt + ((p - pccmax) / (cmax - pccmax)) * (1.0 - pt))


def _feature_kernels(pixels_per_degree):
    w = 0.082
    sd = 0.5 * w * pixels_per_degree
    radius = int(np.ceil(3 * sd))
    rng = np.arange(-radius, radius + 1)
    x, y = np.meshgrid(rng, rng)
    g = np.exp(-(x ** 2 + y ** 2) / (2 * sd * sd))

    def normalize(gx):
        neg = -gx[gx < 0].sum()
        pos = gx[gx > 0].sum()
        return np.where(gx < 0, gx / neg, gx / pos).astype(np.float32)

    edge = normalize(-x * g)
    point = normalize((x ** 2 / (sd * sd) - 1) * g)
    return edge, point


def _feature_mag(y_img, kernel):
    kx = _const(kernel, y_img)
    fx = _conv2d_replicate(y_img[..., None], kx)[..., 0]
    fy = _conv2d_replicate(y_img[..., None], kx.T.contiguous())[..., 0]
    return torch.sqrt(fx ** 2 + fy ** 2)


def flip_error_map(reference, test, pixels_per_degree=None, device=None):
    """Per-pixel FLIP error in [0, 1], (h, w) float32 on ``device`` (that of
    ``reference`` when it is a tensor, else the CPU). reference/test:
    (h, w, 3) sRGB in [0, 1], numpy arrays or tensors."""
    if pixels_per_degree is None:
        pixels_per_degree = default_pixels_per_degree()
    if device is None:
        device = reference.device if isinstance(reference, torch.Tensor) else "cpu"
    reference = torch.as_tensor(reference, dtype=torch.float32, device=device)
    test = torch.as_tensor(test, dtype=torch.float32, device=device)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref_yc = xyz_to_ycxcz(linear_to_xyz(srgb_to_linear(reference)))
        test_yc = xyz_to_ycxcz(linear_to_xyz(srgb_to_linear(test)))

        kernels, _ = _csf_filter_bank(pixels_per_degree)
        ref_f = hunt_adjust(xyz_to_lab(linear_to_xyz(_spatial_filter(ref_yc, kernels))))
        test_f = hunt_adjust(xyz_to_lab(linear_to_xyz(_spatial_filter(test_yc, kernels))))

        delta_hyab = hyab(ref_f, test_f) ** _QC
        green = hunt_adjust(xyz_to_lab(linear_to_xyz(_const([[[0.0, 1.0, 0.0]]], ref_f))))
        blue = hunt_adjust(xyz_to_lab(linear_to_xyz(_const([[[0.0, 0.0, 1.0]]], ref_f))))
        cmax = float(hyab(green, blue)[0, 0]) ** _QC
        delta_c = _redistribute(delta_hyab, cmax)

        ref_y = (ref_yc[..., 0] + 16.0) / 116.0
        test_y = (test_yc[..., 0] + 16.0) / 116.0
        edge_k, point_k = _feature_kernels(pixels_per_degree)
        delta_f = torch.maximum(
            (_feature_mag(ref_y, edge_k) - _feature_mag(test_y, edge_k)).abs(),
            (_feature_mag(test_y, point_k) - _feature_mag(ref_y, point_k)).abs())
        delta_f = (((1.0 / math.sqrt(2.0)) * delta_f) ** _QF).clamp(0.0, 1.0)
        return delta_c ** (1.0 - delta_f)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def flip_value(reference, test, pixels_per_degree=None) -> float:
    return float(flip_error_map(reference, test, pixels_per_degree).mean())
