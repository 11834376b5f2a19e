"""Dataset builder — capability parity with the reference's
``generate_testsample.py`` (zip sorted clean/hazy folders → one ``{i}.h5``
per pair with float [0,1] HWC datasets ``gt`` + ``haze``, :29-38), with the
hardcoded paths (:18-35) replaced by flags. A copy of
``fdgan_tpu/cli/generate_testsample.py``; it needs h5py and PIL.

    python -m fdgan_tpu_torch.cli.generate_testsample --gt_dir clean/ --haze_dir hazy/ --out_dir ds/
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gt_dir", required=True, help="folder of clean images")
    p.add_argument("--haze_dir", required=True, help="folder of corresponding hazy images")
    p.add_argument("--out_dir", required=True, help="output dataroot for {i}.h5 files")
    opt = p.parse_args(argv)

    import h5py
    from PIL import Image

    gts = sorted(os.listdir(opt.gt_dir))
    hazes = sorted(os.listdir(opt.haze_dir))
    os.makedirs(opt.out_dir, exist_ok=True)

    for i, (gt, haze) in enumerate(zip(gts, hazes)):
        gt_image = np.float32(np.asarray(Image.open(os.path.join(opt.gt_dir, gt)).convert("RGB"))) / 255.0
        haze_image = np.float32(np.asarray(Image.open(os.path.join(opt.haze_dir, haze)).convert("RGB"))) / 255.0
        with h5py.File(os.path.join(opt.out_dir, f"{i}.h5"), "w") as f:
            f.create_dataset("gt", data=gt_image)
            f.create_dataset("haze", data=haze_image)
        print(i + 1)
    print("end")


if __name__ == "__main__":
    main()
