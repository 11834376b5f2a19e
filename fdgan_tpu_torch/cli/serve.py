"""Dehaze a directory of raw images, or serve HTTP, through the port's engine.

Counterpart of ``fdgan_tpu/cli/serve.py``: streams PNG/JPG inputs of any
size through ``fdgan_tpu_torch.serve.InferenceEngine`` (shape buckets, batch
ladder, pipelined dispatch) and writes dehazed PNGs with the reference's
normalize=True protocol (demo.py:151).

    python -m fdgan_tpu_torch.cli.serve --inDir hazy/ --outDir dehazed/ \
        --netG netG.pth --device cuda
    python -m fdgan_tpu_torch.cli.serve --http 8731 --netG netG.pth
    python -m fdgan_tpu_torch.cli.serve --inDir ntire/ --outDir dehazed/ \
        --netG netG.pth --tile 512 --halo 128
"""

from __future__ import annotations

import argparse
import os
import time

EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--inDir", default="", help="directory of hazy images "
                   "(required unless --http is given)")
    p.add_argument("--outDir", default="./result_serve/")
    p.add_argument("--netG", default="", help="generator checkpoint (.pth or JAX params .msgpack); "
                   "random-init weights when omitted")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--bn_mode", choices=["batch", "running"], default="running")
    p.add_argument("--bucket", type=int, default=64)
    p.add_argument("--maxBatch", type=int, default=8)
    p.add_argument("--batchSizes", default="",
                   help="explicit comma-separated batch ladder (e.g. 1,2,4,8); "
                        "overrides --maxBatch")
    p.add_argument("--depth", type=int, default=4, help="in-flight batches")
    p.add_argument("--maxWait", type=float, default=0.0,
                   help="flush a partly filled batch once its oldest image has "
                        "waited this many seconds (0 = wait for a full batch; "
                        "--http defaults to 0.05)")
    p.add_argument("--tile", type=int, default=0,
                   help="halo-tile images larger than this on either axis (0 = off)")
    p.add_argument("--halo", type=int, default=128)
    p.add_argument("--http", type=int, default=0, metavar="PORT",
                   help="serve an HTTP API instead of a folder pass: POST "
                        "/dehaze, GET /healthz, GET /stats, POST /reload")
    p.add_argument("--httpHost", default="127.0.0.1",
                   help="bind address for --http (default loopback)")
    p.add_argument("--outputDtype", choices=["float32", "uint8"], default="float32",
                   help="uint8 quantises results on the device: a 4x smaller "
                        "fetch at <= 1/255 per pixel")
    p.add_argument("--inputDtype", choices=["float32", "uint8"], default="float32",
                   help="uint8 uploads raw bytes and normalises on the device "
                        "(bit-identical for 8-bit sources)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def main(argv=None):
    opt = build_parser().parse_args(argv)

    import torch

    from fdgan_tpu_torch.cli._common import load_generator, save_image_normalized
    from fdgan_tpu_torch.serve import InferenceEngine
    from fdgan_tpu_torch.utils.images import load_rgb_image

    if not opt.http:
        if not opt.inDir:
            raise SystemExit("--inDir is required (or pass --http PORT)")
        names = sorted(f for f in os.listdir(opt.inDir) if f.lower().endswith(EXTS))
        if not names:
            raise SystemExit(f"no images ({'/'.join(EXTS)}) in {opt.inDir}")
        os.makedirs(opt.outDir, exist_ok=True)
        # stem.png unless two inputs share a stem (a.jpg + a.png): then keep
        # the full name so nothing is silently overwritten
        stems = [os.path.splitext(n)[0] for n in names]
        out_names = [(s if stems.count(s) == 1 else n) + ".png" for s, n in zip(stems, names)]

    if opt.netG:
        model = load_generator(opt.netG, device=opt.device)
    else:
        from fdgan_tpu_torch.models.fdgan import FDGAN

        print("warning: no --netG given; using random-init weights (smoke mode)")
        model = FDGAN(generator=torch.Generator().manual_seed(0))

    if opt.batchSizes:
        try:
            rungs = [int(b) for b in opt.batchSizes.split(",") if b.strip()]
        except ValueError:
            raise SystemExit(f"--batchSizes must be comma-separated ints, got {opt.batchSizes!r}")
        if not rungs or any(b < 1 for b in rungs):
            raise SystemExit(f"--batchSizes rungs must be >= 1, got {opt.batchSizes!r}")
        ladder = tuple(sorted(set(rungs)))
    else:
        ladder = tuple(sorted({b for b in (1, 2, 4, 8, 16) if b < opt.maxBatch}
                              | {max(1, opt.maxBatch)}))
    engine = InferenceEngine(
        model,
        device=opt.device,
        precision=opt.precision,
        bn_mode=opt.bn_mode,
        bucket=opt.bucket,
        batch_sizes=ladder,
        tile=opt.tile,
        halo=opt.halo,
        output=opt.outputDtype,
        input=opt.inputDtype,
    )
    del model

    if opt.http:
        from fdgan_tpu_torch.serve_http import make_server, serve_forever

        server = make_server(
            engine,
            host=opt.httpHost,
            port=opt.http,
            max_wait=opt.maxWait if opt.maxWait > 0 else 0.05,
            depth=opt.depth,
            # POST /reload re-reads --netG by default
            weight_loader=lambda path: load_generator(path, device=opt.device),
            weights_path=opt.netG,
        )
        serve_forever(server)
        return

    def load_all():
        for name in names:
            img = load_rgb_image(os.path.join(opt.inDir, name))  # fp32 [0, 255]
            # uint8 engines take the decoder's bytes (exact: the values are
            # integral); float engines take [0, 1]
            yield img.astype("uint8") if opt.inputDtype == "uint8" else img / 255.0

    t0 = time.time()
    results = engine.stream(load_all(), depth=opt.depth, max_wait=opt.maxWait)
    for name, out_name, out in zip(names, out_names, results):
        save_image_normalized(out, os.path.join(opt.outDir, out_name))
        print(name)
    dt = time.time() - t0
    print(
        f"{len(names)} images in {dt:.2f}s ({len(names) / dt:.2f} img/s); "
        f"padding overhead: {engine.stats['padded_frac']:.1%}; "
        f"kernel launches: K1 {engine.stats['k1_launches']}, K2 {engine.stats['k2_launches']}"
    )


if __name__ == "__main__":
    main()
