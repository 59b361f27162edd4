"""Quantitative evaluation of a trained run: PSNR, FLIP, IW-SSIM and the
analytic complexity, as ``adanerf_tpu/evaluation`` computes them."""
