"""Inference CLI — drop-in for the reference's ``demo.py`` on the GPU.

Counterpart of ``fdgan_tpu/cli/demo.py``: the same flags (demo.py:28-51),
the same output protocol (a per-batch latency print, then each image's index
and a normalised PNG ``{index}.png`` under ./result_AAAI20/image/,
demo.py:131-151), the same forward (``models.fdgan_fast.apply``), and the
same extensions:

  --precision bf16      bf16 parameters and input (the output comes back fp32)
  --tile N --halo H     halo-tiled high-res inference (NTIRE ≥1600px)
  --profile_dir DIR     torch.profiler Chrome trace (DIR/trace.json)
  --bn_mode running     conventional eval-mode BN (reference default is
                        train-mode batch stats, README.md:38)
  --device DEV          where the forward runs: cuda (default) or cpu

    python -m fdgan_tpu_torch.cli.demo --valDataroot ds/ --netG netG.pth
    python -m fdgan_tpu_torch.cli.demo --valDataroot ds/ --netG netG.pth --device cpu

:func:`dehaze` is the path without files: it takes a model and any loader
of NHWC float batches (``data.h5.DataLoader`` over h5 files or over a list
of arrays) and yields the dehazed images.
"""

from __future__ import annotations

import argparse
import copy
import os
import time
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # reference flags (demo.py:28-51). The train-loop ones (lrD/lrG/beta1/
    # netD/display/evalIter/...) are accepted-but-ignored at inference,
    # exactly as the reference's demo.py ignores them — kept so existing
    # invocation scripts are drop-in compatible.
    p.add_argument("--dataset", default="pix2pix")
    p.add_argument("--valDataroot", default="", help="path to val dataset")
    p.add_argument("--mode", default="B2A")
    p.add_argument("--valBatchSize", type=int, default=1)
    p.add_argument("--batchSize", type=int, default=1)
    p.add_argument("--originalSize", type=int, default=1024)
    p.add_argument("--imageSize", type=int, default=1024)
    p.add_argument("--inputChannelSize", type=int, default=3)
    p.add_argument("--outputChannelSize", type=int, default=3)
    p.add_argument("--lrD", type=float, default=0.0002)
    p.add_argument("--lrG", type=float, default=0.0002)
    p.add_argument("--netG", default="", help="path to netG (.pth, or a JAX params .msgpack)")
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--netD", default="")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--display", type=int, default=5)
    p.add_argument("--evalIter", type=int, default=500)
    # extensions
    p.add_argument("--outDir", default="./result_AAAI20/image/")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32")
    p.add_argument("--bn_mode", choices=["batch", "running"], default="batch")
    p.add_argument("--tile", type=int, default=0, help="tile size for halo-tiled inference (0 = off)")
    p.add_argument("--halo", type=int, default=128)
    p.add_argument("--profile_dir", default="")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def dehaze(
    model,
    loader: Iterable,
    *,
    precision: str = "fp32",
    bn_mode: str = "batch",
    tile: int = 0,
    halo: int = 128,
    device="cuda",
    impl: str = "kernels",
) -> Iterator[Tuple[int, float, np.ndarray]]:
    """Dehaze every image of ``loader``; yields ``(index, seconds, image)``
    per image, in order.

    ``loader`` yields batches whose first entry is NHWC float haze in
    [0, 1] (the pix2pix 2-tuple and the pix2pix_val 4-tuple). Each batch is
    reflect-padded on the host up to H, W divisible by 8 (the padded pixels
    enter the batch-BN statistics, as in the JAX demo), uploaded, run
    through ``fdgan_fast.apply`` under ``torch.inference_mode`` (in tiles
    with ``tile`` > 0, each tile with its own batch statistics), and
    cropped back. ``image`` is HWC float32 in [-1, 1]; ``seconds`` is the
    forward's time for the image's batch, the device synchronised before
    the clock is read. ``model`` is cast to ``precision`` (a copy, when it
    is not already in that dtype on ``device``). ``impl='plain'`` runs the
    kernels' plain twins instead of the kernels.
    """
    from fdgan_tpu_torch.cli._common import fp32_exact
    from fdgan_tpu_torch.dist.tiling import tiled_apply
    from fdgan_tpu_torch.models import fdgan_fast

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    dtype = _DTYPES[precision]
    p = next(model.parameters())
    if p.dtype != dtype or p.device != device:
        model = copy.deepcopy(model).to(device=device, dtype=dtype)
    cuda = device.type == "cuda"

    def forward(t: torch.Tensor) -> torch.Tensor:
        return fdgan_fast.apply(model, t, bn_mode=bn_mode, impl=impl)

    run = (lambda t: tiled_apply(forward, t, tile=tile, halo=halo)) if tile else forward
    index = -1
    for batch in loader:
        haze = np.asarray(batch[0], np.float32)  # pix2pix 2-tuple / pix2pix_val 4-tuple
        # FDGAN needs H, W divisible by 8 (three ÷2 stages); real NTIRE
        # images are arbitrary — reflect-pad up, crop the output back
        h0, w0 = haze.shape[1], haze.shape[2]
        ph, pw = (-h0) % 8, (-w0) % 8
        if ph or pw:
            haze = np.pad(haze, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
        x = torch.from_numpy(haze).to(device).to(dtype)
        with torch.inference_mode(), fp32_exact(precision, device):
            if cuda:
                torch.cuda.synchronize(device)
            start = time.perf_counter()
            y = run(x)
            if cuda:
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - start
        y = y[:, :h0, :w0].float().cpu().numpy()
        for i in range(y.shape[0]):
            index += 1
            yield index, seconds, y[i]


def main(argv=None):
    opt = build_parser().parse_args(argv)
    print(opt)

    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("demo: no CUDA device; pass --device cpu to run on the CPU")

    from fdgan_tpu_torch.cli._common import load_generator, maybe_profile, save_image_normalized
    from fdgan_tpu_torch.data import get_loader

    loader = get_loader(
        opt.dataset,
        opt.valDataroot,
        opt.imageSize,
        opt.imageSize,
        batch_size=opt.valBatchSize,
        workers=opt.workers,
        split="Train",
        shuffle=False,
        seed=None,
    )
    model = load_generator(opt.netG, device=device, dtype=_DTYPES[opt.precision])

    os.makedirs(opt.outDir, exist_ok=True)
    with maybe_profile(opt.profile_dir or None):
        for index, seconds, y in dehaze(
            model, loader, precision=opt.precision, bn_mode=opt.bn_mode, tile=opt.tile, halo=opt.halo,
            device=device,
        ):
            if index % opt.valBatchSize == 0:
                print(seconds)  # per-batch latency (demo.py:131-135)
            print(index)
            save_image_normalized(y, os.path.join(opt.outDir, f"{index}.png"))


if __name__ == "__main__":
    main()
