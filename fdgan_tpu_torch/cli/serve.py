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
    python -m fdgan_tpu_torch.cli.serve --inDir hazy/ --outDir dehazed/ --artifact netG_512.pt2
    python -m fdgan_tpu_torch.cli.serve --inDir hazy/ --outDir dehazed/ --model dehazeformer_b \
        --netG dehazeformer-b.pth --inputDtype uint8 --outputDtype uint8

``--model dehazeformer_b`` serves DehazeFormer-B (``models/dehazeformer.py``)
instead of FD-GAN: ``--netG`` is then a state dict with the published names
(``relative_positions`` entries dropped), ``--bucket`` defaults to the
model's multiple of 4, ``--bn_mode`` does not apply, and ``--tile``,
``--dataShards`` and ``--spatialShards`` are FD-GAN's only.

``--artifact`` serves a folder through an exported program
(``cli/convert --dst x.pt2``, ``io.export.ArtifactRunner``: weights
inside, no model code), as the JAX CLI serves a ``.shlo``; its device is
the program's, and it runs with TF32 off (the fp32 programs' contract).

``--warmup 384x512,720x1280`` runs every batch-ladder rung at each shape's
bucket once before serving starts, and ``--http`` does so at the bucket
shape unless ``--noWarmup``; ``--autoWarm`` (on by default with ``--http``,
off with ``--noAutoWarm``) runs a new bucket's other rungs in the background
after its first batch (``InferenceEngine.warmup``, ``auto_warm``), as the
JAX CLI's flags do. Eager PyTorch compiles no program per shape; what a
shape's first batch pays here is the kernels' library and CUDA's lazy
loading of its modules, cuDNN's choice of algorithms for the shape and the
caching allocator's growth.

A data × spatial mesh runs one process a card, started as the training
CLI's ranks are (``FDGAN_TPU_DIST`` with its coordinates, or torchrun),
with world size dataShards × spatialShards; rank 0 reads, serves and
writes, the other ranks run its batches:

    FDGAN_TPU_DIST=1 torchrun --nproc-per-node 4 -m fdgan_tpu_torch.cli.serve \
        --inDir big/ --outDir dehazed/ --dataShards 1 --spatialShards 4
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
    p.add_argument("--model", choices=["fdgan", "dehazeformer_b"], default="fdgan",
                   help="the served model: FD-GAN's generator, or DehazeFormer-B")
    p.add_argument("--netG", default="", help="generator checkpoint (.pth or JAX params .msgpack; for "
                   "dehazeformer_b a .pth state dict with the published names); random-init weights when omitted")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="bf16")
    p.add_argument("--bn_mode", choices=["batch", "running"], default="running")
    p.add_argument("--bucket", type=int, default=None,
                   help="spatial bucket (default 64 for fdgan, the model's multiple of 4 for dehazeformer_b)")
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
    p.add_argument("--warmup", default="",
                   help="comma-separated HxW input shapes (e.g. '384x512,720x1280') to run once, every batch "
                        "ladder rung per shape, before serving starts: a shape's first batch pays for cuDNN's "
                        "choice of algorithms, CUDA's lazy loading of the kernels and the allocator's growth. "
                        "--http defaults to warming the bucket shape's full ladder even without this flag")
    p.add_argument("--noWarmup", action="store_true",
                   help="skip the default --http startup warmup (the first requests then pay it)")
    p.add_argument("--autoWarm", action="store_true",
                   help="when a NEW shape bucket runs its first batch on the request path, run its other batch "
                        "ladder rungs on a background thread (shapes not known at --warmup time). Default ON "
                        "for --http: the startup warmup covers only the bucket shape, and real photos bucket "
                        "larger")
    p.add_argument("--noAutoWarm", action="store_true", help="disable the --http default auto-warm")
    p.add_argument("--artifact", default="",
                   help="serve the folder from an exported program (.pt2 from cli/convert; weights inside, "
                        "no model code) instead of the engine")
    p.add_argument("--outputDtype", choices=["float32", "uint8"], default="float32",
                   help="uint8 quantises results on the device: a 4x smaller "
                        "fetch at <= 1/255 per pixel")
    p.add_argument("--inputDtype", choices=["float32", "uint8"], default="float32",
                   help="uint8 uploads raw bytes and normalises on the device "
                        "(bit-identical for 8-bit sources)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu); under a process "
                   "group on cuda each rank takes its own card")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend under FDGAN_TPU_DIST (default: nccl on cuda, gloo on the "
                        "CPU; gloo for ranks that share a card, which NCCL refuses)")
    p.add_argument("--dataShards", type=int, default=0,
                   help="shard batches over this many ranks (mesh 'data' "
                        "axis; 0 = no mesh, single device)")
    p.add_argument("--spatialShards", type=int, default=1,
                   help="with --dataShards: also shard the image H axis over "
                        "this many ranks (latency lever for large images)")
    return p


def main(argv=None):
    opt = build_parser().parse_args(argv)
    if opt.artifact:
        if opt.http:
            raise SystemExit("--http serves the live engine; an exported program has no streaming path "
                             "(drop --artifact or --http)")
        if opt.dataShards or opt.spatialShards > 1:
            raise SystemExit("--artifact runs one program in one process: drop --dataShards/--spatialShards")
        return _serve_artifact(opt)
    opt.bucket = bucket_of(opt)
    shapes = warmup_shapes(opt)
    import torch

    from fdgan_tpu_torch.dist import mesh as dmesh
    from fdgan_tpu_torch.serve import InferenceEngine

    n_data = opt.dataShards or (1 if opt.spatialShards > 1 else 0)
    mesh, rank = None, 0
    if n_data:
        n = n_data * opt.spatialShards
        dmesh.maybe_init_distributed(opt.device, opt.backend)
        if n > 1 and not torch.distributed.is_initialized():
            raise SystemExit(f"mesh {n_data}x{opt.spatialShards} needs {n} ranks, one process each: start them with "
                             f"FDGAN_TPU_DIST=1 and FDGAN_TPU_DIST_COORD/_NPROCS={n}/_PID, or "
                             f"FDGAN_TPU_DIST=1 torchrun --nproc-per-node {n}")
        if dmesh.world_size() != n:
            raise SystemExit(f"mesh {n_data}x{opt.spatialShards} needs {n} ranks, have {dmesh.world_size()}")
        if torch.device(opt.device).type == "cuda" and torch.device(opt.device).index is None:
            opt.device = str(dmesh.local_device())
        if torch.distributed.is_initialized():
            mesh = dmesh.make_mesh(n_data, opt.spatialShards, torch.device(opt.device).type)
            rank = dmesh.rank()

    if not opt.http and rank == 0:
        names, out_names = _folder(opt)

    if opt.netG:
        model = load_served(opt, opt.netG)
    elif opt.model == "fdgan":
        from fdgan_tpu_torch.models.fdgan import FDGAN

        print("warning: no --netG given; using random-init weights (smoke mode)")
        model = FDGAN(generator=torch.Generator().manual_seed(0))
    else:
        from fdgan_tpu_torch.models.dehazeformer import dehazeformer_b

        print("warning: no --netG given; using random-init weights (smoke mode)")
        model = dehazeformer_b(generator=torch.Generator().manual_seed(0))

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
        if n_data:
            ladder = tuple(b * n_data for b in ladder)
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
        mesh=mesh,
        spatial=opt.spatialShards > 1,
        auto_warm=(opt.autoWarm or bool(opt.http)) and not opt.noAutoWarm,
    )
    del model
    if rank != 0:  # rank 0 reads, serves and writes
        engine.serve_worker()
        return
    try:
        if shapes:
            t0 = time.time()
            engine.warmup(shapes)
            print(f"warmed {len(shapes)} shape(s) x {len(engine.batch_sizes)} ladder rungs in "
                  f"{time.time() - t0:.1f}s ({engine.stats['compiles']} compiles)")
        _serve(opt, engine, names if not opt.http else None, out_names if not opt.http else None)
    finally:
        engine.close()


def bucket_of(opt) -> int:
    """``--bucket``, else the model's default: 64 for FD-GAN, DehazeFormer's
    own multiple (RLN sees the padding)."""
    if opt.bucket is not None:
        return opt.bucket
    if opt.model == "fdgan":
        return 64
    from fdgan_tpu_torch.models.dehazeformer import DehazeFormer

    return DehazeFormer.multiple


def load_served(opt, path: str):
    """The served model of ``--model`` from ``path``: FD-GAN's generator by
    ``load_generator``; DehazeFormer-B from a ``.pth`` state dict with the
    published names (``published_state_dict``)."""
    if opt.model == "fdgan":
        from fdgan_tpu_torch.cli._common import load_generator

        return load_generator(path, device=opt.device)
    import torch

    from fdgan_tpu_torch.models.dehazeformer import dehazeformer_b, published_state_dict

    model = dehazeformer_b(device="cpu")
    model.load_state_dict(published_state_dict(torch.load(path, map_location="cpu", weights_only=True)), strict=True)
    return model.to(opt.device)


def warmup_shapes(opt) -> list:
    """The (H, W) shapes to warm before serving: ``--warmup``'s, else the
    bucket shape for ``--http`` (unless ``--noWarmup``), else none. Stops on
    a ``--warmup`` that does not parse, with the JAX CLI's message."""
    if opt.warmup:
        try:
            shapes = [tuple(int(d) for d in s.lower().split("x")) for s in opt.warmup.split(",") if s.strip()]
            if any(len(s) != 2 for s in shapes):
                raise ValueError
        except ValueError:
            raise SystemExit(f"--warmup must look like '384x512,720x1280', got {opt.warmup!r}")
        return shapes
    if opt.http and not opt.noWarmup:
        # before the port is bound: a server reachable on the network would otherwise make its first
        # requests at each rung pay the cold start
        return [(bucket_of(opt),) * 2]
    return []


def _folder(opt):
    """The input names of --inDir and their output names (stem.png unless
    two inputs share a stem, a.jpg + a.png: then the full name, so that
    nothing is silently overwritten)."""
    if not opt.inDir:
        raise SystemExit("--inDir is required (or pass --http PORT)")
    names = sorted(f for f in os.listdir(opt.inDir) if f.lower().endswith(EXTS))
    if not names:
        raise SystemExit(f"no images ({'/'.join(EXTS)}) in {opt.inDir}")
    os.makedirs(opt.outDir, exist_ok=True)
    stems = [os.path.splitext(n)[0] for n in names]
    return names, [(s if stems.count(s) == 1 else n) + ".png" for s, n in zip(stems, names)]


def _serve_artifact(opt):
    """--artifact: the folder through ``io.export.ArtifactRunner``, as
    ``fdgan_tpu/cli/serve.py:147-163``."""
    import numpy as np

    from fdgan_tpu_torch.cli._common import fp32_exact, save_image_normalized
    from fdgan_tpu_torch.io.export import ArtifactRunner
    from fdgan_tpu_torch.utils.images import load_rgb_image

    names, out_names = _folder(opt)
    runner = ArtifactRunner(opt.artifact)
    bdesc = runner.batch if runner.batch is not None else "poly"
    print(f"serving from artifact {opt.artifact} ({bdesc}x{runner.height}x{runner.width}, {runner.input} in, "
          f"on {runner.device})")
    imgs = [load_rgb_image(os.path.join(opt.inDir, n)) / 255.0 for n in names]
    t0 = time.time()
    with fp32_exact("fp32", runner.device):
        results = runner(imgs, group=opt.maxBatch)
    for name, out_name, out in zip(names, out_names, results):
        save_image_normalized(out.astype(np.float32), os.path.join(opt.outDir, out_name))
        print(name)
    dt = time.time() - t0
    print(f"{len(names)} images in {dt:.2f}s ({len(names) / dt:.2f} img/s)")


def _serve(opt, engine, names, out_names):
    """Rank 0's part: the HTTP server, or the folder pass."""
    from fdgan_tpu_torch.cli._common import save_image_normalized
    from fdgan_tpu_torch.utils.images import load_rgb_image

    if opt.http:
        from fdgan_tpu_torch.serve_http import make_server, serve_forever

        server = make_server(
            engine,
            host=opt.httpHost,
            port=opt.http,
            max_wait=opt.maxWait if opt.maxWait > 0 else 0.05,
            depth=opt.depth,
            # POST /reload re-reads --netG by default
            weight_loader=lambda path: load_served(opt, path),
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
    if opt.model == "fdgan":
        launches = f"K1 {engine.stats['k1_launches']}, K2 {engine.stats['k2_launches']}"
    else:
        from fdgan_tpu_torch.ops import window_attention

        launches = f"window_attention {window_attention.launches}"
    print(
        f"{len(names)} images in {dt:.2f}s ({len(names) / dt:.2f} img/s); "
        f"padding overhead: {engine.stats['padded_frac']:.1%}; "
        f"kernel launches: {launches}"
    )


if __name__ == "__main__":
    main()
