"""Information-content weighted SSIM (Wang & Li, IEEE TIP 2011).

Counterpart of ``adanerf_tpu/evaluation/iw_ssim.py``: a 5-scale Laplacian
pyramid (Burt-Adelson binom-5 kernel, mirror boundaries), per-scale
contrast-structure SSIM maps (luminance at the coarsest scale only) and
per-scale information weights from a local Gaussian-scale-mixture model,
combined with the MS-SSIM exponents. All in float64.

The JAX package filters with OpenCV, which the GPU machine may lack. Here
``cv2.filter2D`` (a correlation, with ``BORDER_REFLECT_101`` or
``BORDER_CONSTANT``) is ``F.conv2d`` on a reflect- or zero-padded float64
tensor on the CPU, and ``cv2.resize`` with ``INTER_LINEAR`` is
``_resize_linear``, which places samples as OpenCV does (source
coordinate ``(i + 0.5) * scale - 0.5``, clamped at the borders).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_BINOM5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
_K1, _K2, _L = 0.01, 0.03, 255
_WEIGHTS = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])
_WIN_SIZE, _WIN_SIGMA = 11, 1.5
_BLK = 3
_SIGMA_NSQ = 0.4
_TOL = 1e-15


def filter2d(img, kernel, border="reflect101"):
    """``cv2.filter2D(img, -1, kernel, borderType=...)`` in float64: the
    correlation of a 2-D image with an odd square kernel, same size out;
    ``border`` is "reflect101" (mirror without repeating the edge) or
    "constant" (zeros)."""
    r = kernel.shape[0] // 2
    x = torch.from_numpy(np.ascontiguousarray(img, np.float64))[None, None]
    x = F.pad(x, (r, r, r, r), mode="reflect") if border == "reflect101" \
        else F.pad(x, (r, r, r, r))
    k = torch.from_numpy(np.ascontiguousarray(kernel, np.float64))[None, None]
    return F.conv2d(x, k)[0, 0].numpy()


def _linear_taps(n_src, n_dst):
    """OpenCV's INTER_LINEAR taps along one axis: (left index, right index,
    left weight, right weight)."""
    scale = 1.0 / (n_dst / n_src)
    fx = (np.arange(n_dst) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    low = sx < 0
    fx[low], sx[low] = 0.0, 0
    high = sx >= n_src - 1
    fx[high], sx[high] = 0.0, n_src - 1
    return sx, np.minimum(sx + 1, n_src - 1), 1.0 - fx, fx


def _resize_linear(img, out_h, out_w):
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``
    for a float64 image: horizontal taps first, then vertical."""
    y0, y1, wy0, wy1 = _linear_taps(img.shape[0], out_h)
    x0, x1, wx0, wx1 = _linear_taps(img.shape[1], out_w)
    rows = img[:, x0] * wx0 + img[:, x1] * wx1
    return rows[y0] * wy0[:, None] + rows[y1] * wy1[:, None]


def _filter2_sep(img, k):
    """Separable 2-D correlation with mirror boundaries (reflect-101)."""
    return filter2d(img, np.outer(k, k))


def _downsample(img):
    return _filter2_sep(img, _BINOM5)[::2, ::2]


def _upsample(img, out_shape):
    up = np.zeros(out_shape, np.float64)
    up[::2, ::2] = img
    return _filter2_sep(up, 2.0 * _BINOM5)


def laplacian_pyramid(img, levels=5):
    """Burt-Adelson Laplacian pyramid; last level is the low-pass residual."""
    pyr = []
    cur = img.astype(np.float64)
    for _ in range(levels - 1):
        down = _downsample(cur)
        up = _upsample(down, cur.shape)
        pyr.append(cur - up)
        cur = down
    pyr.append(cur)
    return pyr


def _gaussian_window(ws=_WIN_SIZE, sigma=_WIN_SIGMA):
    half = ws // 2
    x, y = np.mgrid[-half:half + 1, -half:half + 1]
    g = np.exp(-(x ** 2 + y ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _conv_valid(img, win):
    full = filter2d(img, win, "constant")
    r = win.shape[0] // 2
    return full[r:img.shape[0] - r, r:img.shape[1] - r]


def _scale_quality_maps(pyr_o, pyr_d):
    win = _gaussian_window()
    c1 = (_K1 * _L) ** 2
    c2 = (_K2 * _L) ** 2
    cs_maps = []
    l_map = None
    n = len(pyr_o)
    for i in range(n):
        o, d = pyr_o[i], pyr_d[i]
        mu1 = _conv_valid(o, win)
        mu2 = _conv_valid(d, win)
        s12 = _conv_valid(o * d, win) - mu1 * mu2
        s11 = np.maximum(_conv_valid(o * o, win) - mu1 ** 2, 0)
        s22 = np.maximum(_conv_valid(d * d, win) - mu2 ** 2, 0)
        cs_maps.append((2 * s12 + c2) / (s11 + s22 + c2))
        if i == n - 1:
            l_map = (2 * mu1 * mu2 + c1) / (mu1 ** 2 + mu2 ** 2 + c1)
    return l_map, cs_maps


def _enlarge2(im):
    """4x bilinear enlarge then 2x decimate with linear boundary extension —
    the parent-band upsampling."""
    M, N = im.shape
    t1 = _resize_linear(im, 4 * M - 3, 4 * N - 3)
    t2 = np.zeros((4 * M - 1, 4 * N - 1), np.float64)
    t2[1:-1, 1:-1] = t1
    t2[0, :] = 2 * t2[1, :] - t2[2, :]
    t2[-1, :] = 2 * t2[-2, :] - t2[-3, :]
    t2[:, 0] = 2 * t2[:, 1] - t2[:, 2]
    t2[:, -1] = 2 * t2[:, -2] - t2[:, -3]
    return t2[::2, ::2]


def _info_weight_maps(pyr_o, pyr_d, parent=True):
    """Per-scale information-content weights (GSM mutual information)."""
    n = len(pyr_o)
    iw_maps = []
    blk = _BLK
    pad = (blk - 1) // 2
    win = np.ones((blk, blk)) / (blk * blk)

    def box(img):
        return filter2d(img, win, "constant")

    for scale in range(n - 1):
        o, d = pyr_o[scale], pyr_d[scale]
        mean_x = box(o)
        mean_y = box(d)
        cov_xy = box(o * d) - mean_x * mean_y
        ss_x = np.maximum(box(o * o) - mean_x ** 2, 0)
        ss_y = np.maximum(box(d * d) - mean_y ** 2, 0)

        g = cov_xy / (ss_x + _TOL)
        vv = ss_y - g * cov_xy
        g[ss_x < _TOL] = 0
        vv[ss_x < _TOL] = ss_y[ss_x < _TOL]
        ss_x[ss_x < _TOL] = 0
        g[ss_y < _TOL] = 0
        vv[ss_y < _TOL] = 0

        use_parent = parent and scale < n - 2
        nv, nh = o.shape
        nblv = nv - blk + 1
        nblh = nh - blk + 1
        nexp = nblv * nblh
        N = blk * blk + (1 if use_parent else 0)

        # neighborhood matrix Y: (nexp, N)
        cols = []
        for ny in range(-pad, pad + 1):
            for nx in range(-pad, pad + 1):
                rolled = np.roll(np.roll(o, ny, axis=0), nx, axis=1)
                cols.append(rolled[pad:pad + nblv, pad:pad + nblh].ravel())
        if use_parent:
            par = _enlarge2(pyr_o[scale + 1])[:nv, :nh]
            cols.append(par[pad:pad + nblv, pad:pad + nblh].ravel())
        Y = np.stack(cols, axis=1)

        C_u = Y.T @ Y / nexp
        eig_values, H = np.linalg.eigh(C_u)
        pos = eig_values * (eig_values > 0)
        denom = pos.sum() + (pos.sum() == 0)
        L = np.diag(pos) * eig_values.sum() / denom
        C_u = H @ L @ H.T
        C_u_inv = np.linalg.pinv(C_u)
        ss = ((Y @ C_u_inv) * Y).sum(axis=1) / N
        ss = ss.reshape(nblv, nblh)

        g_c = g[pad:pad + nblv, pad:pad + nblh]
        vv_c = vv[pad:pad + nblv, pad:pad + nblh]

        infow = np.zeros_like(g_c)
        for lam in eig_values:
            infow += np.log2(1 + ((vv_c + (1 + g_c * g_c) * _SIGMA_NSQ) * ss * lam
                                  + _SIGMA_NSQ * vv_c) / (_SIGMA_NSQ ** 2))
        infow[infow < _TOL] = 0
        iw_maps.append(infow)
    return iw_maps


def iw_ssim(img_o: np.ndarray, img_d: np.ndarray, levels: int = 5,
            iw_flag: bool = True, parent: bool = True) -> float:
    """IW-SSIM score of a distorted grayscale image vs its reference.

    img_o/img_d: (h, w) grayscale in [0, 255] (the reference feeds
    255-scaled luma, evaluate.py:82-88).
    """
    img_o = np.asarray(img_o, np.float64)
    img_d = np.asarray(img_d, np.float64)
    # the 11x11 SSIM window needs the coarsest band to be >= 11px; the
    # reference assumes large (>=176px) images — reduce levels for small ones
    min_side = min(img_o.shape)
    max_levels = max(1, int(np.floor(np.log2(min_side / _WIN_SIZE))) + 1)
    levels = min(levels, max_levels)
    pyr_o = laplacian_pyramid(img_o, levels)
    pyr_d = laplacian_pyramid(img_d, levels)
    l_map, cs_maps = _scale_quality_maps(pyr_o, pyr_d)
    iw_maps = _info_weight_maps(pyr_o, pyr_d, parent) if iw_flag else None

    bound = int(np.ceil((_WIN_SIZE - 1) / 2))
    bound1 = int(bound - np.floor((_BLK - 1) / 2))

    wmcs = []
    for s in range(levels):
        cs = cs_maps[s]
        if s == levels - 1:
            cs = cs * l_map
        if iw_flag:
            if s < levels - 1:
                iw = iw_maps[s]
                if bound1 != 0:
                    iw = iw[bound1:-bound1, bound1:-bound1]
                h = min(iw.shape[0], cs.shape[0])
                w = min(iw.shape[1], cs.shape[1])
                wmcs.append((cs[:h, :w] * iw[:h, :w]).sum() / iw[:h, :w].sum())
            else:
                wmcs.append(cs.mean())
        else:
            wmcs.append(cs.mean())
    wmcs = np.abs(np.array(wmcs))
    return float(np.prod(wmcs ** _WEIGHTS[:levels]))


def rgb_to_gray255(img: np.ndarray) -> np.ndarray:
    """(h, w, 3) [0,1] -> (h, w) luma in [0,255] for IW-SSIM input."""
    img = np.asarray(img)
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return gray * 255.0
