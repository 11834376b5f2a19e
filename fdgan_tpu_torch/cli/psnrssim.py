"""Metric CLI — drop-in for the reference's ``PSNRSSIM.py`` (same flags
:15-18, same protocol §2.1 #2, same 4-decimal Decimal output :269-273).

The reference's vendored skimage copy needs numpy ≤1.16 private APIs
(PSNRSSIM.py:11); this re-implementation (``ops/metrics.py``) does not.
Keeps the reference's flag-name swap (res_dir = --gt_dir, ref_dir =
--result_dir, PSNRSSIM.py:245-246) — metrics are symmetric, so harmless.
A copy of ``fdgan_tpu/cli/psnrssim.py``.

    python -m fdgan_tpu_torch.cli.psnrssim --gt_dir clean/ --result_dir dehazed/
"""

from __future__ import annotations

import argparse
import os
from decimal import Decimal

import numpy as np


def _open_img(path: str, as_float: bool):
    from PIL import Image

    from fdgan_tpu_torch.ops.metrics import boundary_crop

    arr = np.asarray(Image.open(path).convert("RGB"))
    if as_float:
        arr = arr.astype(float) / 255.0
    return boundary_crop(arr)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gt_dir", default="", help="path to GT images")
    p.add_argument("--result_dir", default="", help="path to dehazed images")
    opt = p.parse_args(argv)

    from fdgan_tpu_torch.ops.metrics import mssim_channels, psnr

    res_dir = opt.gt_dir
    ref_dir = opt.result_dir

    ref_pngs = sorted(f for f in os.listdir(ref_dir) if f.lower().endswith("png"))
    res_pngs = sorted(f for f in os.listdir(res_dir) if f.lower().endswith("png"))

    scores, scores_ssim = [], []
    for ref_im, res_im in zip(ref_pngs, res_pngs):
        v_psnr = psnr(
            _open_img(os.path.join(ref_dir, ref_im), True),
            _open_img(os.path.join(res_dir, res_im), True),
        )
        v_ssim = mssim_channels(
            _open_img(os.path.join(ref_dir, ref_im), False),
            _open_img(os.path.join(res_dir, res_im), False),
        )
        print(ref_im, res_im, "psnr:", v_psnr, "ssim:", v_ssim)
        scores.append(v_psnr)
        scores_ssim.append(v_ssim)

    def fmt(v: float):
        # identical images give MSE 0 → infinite PSNR; the reference's
        # Decimal quantize would raise here (never met in its workflow)
        if not np.isfinite(v):
            return v
        return Decimal(float(v)).quantize(Decimal("0.0000"))

    psnr_mean = fmt(float(np.mean(scores)))
    ssim_mean = fmt(float(np.mean(scores_ssim)))
    print("\n psnr:\n", psnr_mean, "\n compute ssim:\n", ssim_mean)
    return float(psnr_mean), float(ssim_mean)


if __name__ == "__main__":
    main()
