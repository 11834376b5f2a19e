"""Training CLI: the reconstructed FD-GAN adversarial loop on the GPU.

Counterpart of ``fdgan_tpu/cli/train.py``, with the same flags (the
reference's conventions, demo.py:28-51, and the loss-weight flags for its
unpublished weights) and the same streaming loop (``:616-668``) and set-up
(``:197-292``, ``:351-472``):

    python -m fdgan_tpu_torch.cli.train --dataroot ds/ --valDataroot val/ --exp exp/ \\
        --precision bf16 --keepBest
    python -m fdgan_tpu_torch.cli.train --dataroot ds/ --exp exp/ --device cpu --imageSize 32

:func:`train` is the loop without files: it takes any iterables of
``(haze, gt)`` NHWC float numpy batches in [0, 1] (``data.get_loader``'s, or
arrays in memory). Checkpoints are ``exp/ckpt_{step}.pt``
(``io/checkpoint.py``), written every ``--ckptEvery`` epochs and at the end;
a run resumes from the newest one in ``exp``. ``--keepBest`` writes the
generator at the best val PSNR as ``exp/netG_best.pth`` (reference names,
loadable by ``cli/demo --netG`` and ``cli/serve``) with a
``netG_best.pth.json`` sidecar.

``--impl {kernels,plain}`` replaces the JAX CLI's ``xla``/``pallas``: the
port's step always runs ``fdgan_fast``. ``--device`` (default ``cuda``) says
where the loop runs; with no card and no ``--device cpu`` it stops. Flags of
the TPU's workarounds and of what is not ported yet are accepted and refused
with the ROADMAP item that holds them. A run also resumes from the JAX CLI's
``ckpt_{step}.msgpack`` (a whole ``TrainState``), the newest of both kinds
by step.

Multi-process data parallelism is the JAX CLI's (``:162-215``, ``:616-660``):
``FDGAN_TPU_DIST=1`` with ``FDGAN_TPU_DIST_COORD`` / ``_NPROCS`` / ``_PID``,
or under ``torchrun`` (``dist/mesh.py``), one process per card (NCCL), or
per CPU process with ``--device cpu`` (gloo). ``--batchSize`` is global:
each process loads ``batchSize // nprocs`` rows of its own shard of the
data, with the same seed, and the step takes the batch statistics over the
global batch and averages the gradients (``train/loop.py``). Rank 0's state
is broadcast after init and resume; only rank 0 evaluates and writes the
log, the checkpoints and ``netG_best.pth``:

    FDGAN_TPU_DIST=1 FDGAN_TPU_DIST_COORD=host0:29500 FDGAN_TPU_DIST_NPROCS=2 FDGAN_TPU_DIST_PID=0 \
        python -m fdgan_tpu_torch.cli.train --dataroot ds/ --exp exp/ --batchSize 16
    torchrun --nproc-per-node 4 -m fdgan_tpu_torch.cli.train ...   # with FDGAN_TPU_DIST=1 set

``--spatialShards N`` (JAX's memory lever for large images, ``:117-120``,
``:294-331``) splits each image's H axis into bands over N ranks: the world
is n_data × N processes in ``dist.mesh.make_mesh``'s ("data", "spatial")
layout, the ranks of a data group load the same images (the loader's shard
is the data index, rank // N, and the batch ``batchSize // n_data``) and
each keeps its band of rows (``dist.mesh.mesh_block``), and the step is
``train/loop.py``'s with the mesh. JAX's refusal of the flag under
``FDGAN_TPU_DIST`` (each process loading whole images) does not apply here:
the ranks of a data group load the same images with the same seed. One
process holds one card, so a single process refuses the flag; so does the
contextual term (ROADMAP.md, Queue 1 item 11c), and an ``--imageSize`` whose
bands are too thin for the discriminator's tail:

    FDGAN_TPU_DIST=1 torchrun --nproc-per-node 4 -m fdgan_tpu_torch.cli.train ... --imageSize 2048 \
        --batchSize 1 --spatialShards 4 --rematStages --precision bf16
"""

from __future__ import annotations

import argparse
import atexit
import json
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from fdgan_tpu_torch.cli._common import fp32_exact, load_discriminator, load_generator
from fdgan_tpu_torch.dist import mesh
from fdgan_tpu_torch.io.checkpoint import latest_checkpoint, load_checkpoint, load_jax_checkpoint, save_checkpoint

ROADMAP_NOT_PORTED = "ROADMAP.md, Queue 1 item 4: not ported unless the card shows a need"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="pix2pix")
    p.add_argument("--dataroot", default="", help="path to train dataset")
    p.add_argument("--valDataroot", default="")
    p.add_argument("--batchSize", type=int, default=8)
    p.add_argument("--originalSize", type=int, default=286)
    p.add_argument("--imageSize", type=int, default=256)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lrD", type=float, default=0.0002)
    p.add_argument("--lrG", type=float, default=0.0002)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--annealStart", type=int, default=0,
                   help="optimizer step at which linear LR decay begins (0 = decay off, the reference's default)")
    p.add_argument("--annealEvery", type=int, default=400,
                   help="decay reaches 0 this many steps after --annealStart (misc.py:164-172)")
    p.add_argument("--netG", default="", help="generator .pth, ckpt_*.pt or JAX params .msgpack to start from")
    p.add_argument("--netD", default="", help="discriminator .pth or JAX params .msgpack to start from")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--exp", default="./checkpoints_fdgan")
    p.add_argument("--display", type=int, default=5,
                   help="accepted for reference-flag compatibility and ignored; logging is JSONL via --logEvery")
    p.add_argument("--evalIter", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    # loss weights (unpublished in the reference)
    p.add_argument("--lambdaAdv", type=float, default=1.0)
    p.add_argument("--lambdaPixel", type=float, default=100.0)
    p.add_argument("--pixelNorm", choices=["l1", "mse"], default="l1")
    p.add_argument("--lambdaPerceptual", type=float, default=1.0)
    p.add_argument("--lambdaSSIM", type=float, default=1.0)
    p.add_argument("--lambdaCX", type=float, default=0.0)
    p.add_argument("--vggWeights", default="", help=".pth VGG16 weights (perceptual loss off if empty)")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32")
    p.add_argument("--poolSize", type=int, default=50)
    p.add_argument("--logEvery", type=int, default=10)
    p.add_argument("--debugNans", action="store_true", help="torch.autograd.set_detect_anomaly(True)")
    p.add_argument("--accumSteps", type=int, default=1,
                   help="accumulate G grads over this many microbatches (batchSize must divide by it; "
                        "not combined with --poolSize)")
    p.add_argument("--rematStages", action="store_true",
                   help="also checkpoint each encoder block with its transition")
    p.add_argument("--remat", action="store_true",
                   help="recompute each dense layer's core and each decoder stage in the backward")
    p.add_argument("--impl", choices=["kernels", "plain"], default="kernels",
                   help="the CUDA kernels (their plain twins for CPU tensors) or the plain PyTorch path")
    p.add_argument("--clipGrad", type=float, default=0.0, help="global-norm gradient clip (0 = off)")
    p.add_argument("--dcganInit", action="store_true",
                   help="redraw conv/BN weights with the reference's DCGAN init (misc.py:16-22) before "
                        "training: D fully, G except the pretrained densenet121 encoder; per --seed")
    p.add_argument("--labelSmooth", type=float, default=1.0, help="real label for the D loss")
    p.add_argument("--keepBest", action="store_true",
                   help="keep the generator at the best val PSNR and save it as netG_best.pth at exit")
    p.add_argument("--ckptEvery", type=int, default=1,
                   help="save a checkpoint every N epochs (a final one is always written)")
    p.add_argument("--noAsyncCkpt", action="store_true", help="refused: saves are always blocking here")
    p.add_argument("--deviceSteps", type=int, default=0, help="refused: the TPU's device-resident loop")
    p.add_argument("--spatialShards", type=int, default=1,
                   help="split each image's H axis into bands over this many processes (FDGAN_TPU_DIST); the "
                        "memory lever for large images, with --rematStages")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def refuse(opt: argparse.Namespace) -> None:
    """Stop on flags the port accepts for compatibility but does not run."""
    if opt.deviceSteps > 0:
        raise SystemExit("--deviceSteps: the device-resident lax.scan loop is a workaround for the TPU's host "
                         f"link ({ROADMAP_NOT_PORTED}); drop the flag to run the streaming loop")
    if opt.noAsyncCkpt:
        raise SystemExit("--noAsyncCkpt: the port's checkpoint saves are always blocking; AsyncCheckpointer is "
                         f"not ported ({ROADMAP_NOT_PORTED}); drop the flag")
    if opt.spatialShards > 1:
        if not os.environ.get("FDGAN_TPU_DIST"):
            raise SystemExit(f"--spatialShards {opt.spatialShards}: each band of an image is one process with its "
                             "own card; launch N x n_data processes under FDGAN_TPU_DIST, e.g. FDGAN_TPU_DIST=1 "
                             f"torchrun --nproc-per-node {opt.spatialShards} -m fdgan_tpu_torch.cli.train ... "
                             f"--spatialShards {opt.spatialShards}")
        if opt.lambdaCX > 0:
            raise SystemExit("--lambdaCX with --spatialShards > 1: the contextual term meets every position with "
                             "every target position, across the bands; not ported (ROADMAP.md, Queue 1 item 11c)")
        check_bands(opt.imageSize, opt.spatialShards)
    if opt.poolSize > 0 and opt.accumSteps > 1:
        raise SystemExit("--accumSteps > 1 requires --poolSize 0 (the ImagePool G/D split does not "
                         "accumulate; it would silently ignore the flag)")


def check_bands(image_size: int, n_spatial: int) -> None:
    """Stop where ``image_size`` rows do not split into ``n_spatial`` bands
    that the generator (whole blocks of 8 rows, ``dist.mesh.spatial_rows``)
    and the discriminator's tail (``models.discriminators.check_bands``)
    take."""
    from fdgan_tpu_torch.models.discriminators import check_bands as d_check_bands

    try:
        rows = mesh.spatial_rows(image_size, n_spatial)
        d_check_bands([stop - start for start, stop in rows])
    except ValueError as e:
        raise SystemExit(f"--imageSize {image_size} with --spatialShards {n_spatial}: {e}")


def evaluate(g, val_loader: Iterable, device, impl: str = "kernels"):
    """Mean PSNR and SSIM of ``g`` on ``val_loader``, as the JAX CLI's
    ``evaluate`` (``:362-375``): the forward is ``fdgan_fast.apply`` in batch
    BN, fp32 (TF32 off on the card), under ``inference_mode``; PSNR is
    ``ops.metrics.psnr`` on the host of clip((x̂ + 1)/2) against gt, SSIM
    ``ops.ssim.ssim`` of the same."""
    from fdgan_tpu_torch.models import fdgan_fast
    from fdgan_tpu_torch.ops.metrics import psnr
    from fdgan_tpu_torch.ops.ssim import ssim

    psnrs, ssims = [], []
    with torch.inference_mode(), fp32_exact("fp32", device):
        for batch in val_loader:
            haze, gt = (np.asarray(a, np.float32) for a in batch[:2])
            x_hat = fdgan_fast.apply(g, torch.from_numpy(haze).to(device), impl=impl)
            x01 = ((x_hat.float() + 1.0) * 0.5).clamp(0, 1)
            psnrs.append(psnr(x01.cpu().numpy(), gt))
            ssims.append(float(ssim(x01, torch.from_numpy(gt).to(device))))
    return float(np.mean(psnrs)), float(np.mean(ssims))


class _NullLogger:
    """The log of a process other than rank 0: it writes nothing."""

    def log(self, *args, **kwargs):
        pass

    def close(self):
        pass


def train(opt: argparse.Namespace, loader: Iterable, val_loader: Optional[Iterable] = None, device="cuda"):
    """The loop: ``opt`` is :func:`build_parser`'s namespace; ``loader``
    yields ``(haze, gt)`` batches every epoch, ``val_loader`` (or None) the
    val pairs. ``--precision fp32`` runs it without TF32 on the card, as the
    JAX CLI sets ``"highest"`` (``:148-150``). Returns the final
    ``TrainState``.

    In a process group (``dist.mesh.maybe_init_distributed``) the loop is
    this process's share of a data-parallel run: ``loader`` yields this
    process's ``batchSize // nprocs`` rows a batch. With ``--spatialShards
    N`` it yields its data group's ``batchSize // n_data`` whole images, of
    which the loop keeps this rank's band of rows."""
    with fp32_exact(opt.precision, device):
        return _train(opt, loader, val_loader, torch.device(device))


def _train(opt, loader, val_loader, device):
    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.nn.init import DENSENET_PRETRAINED_KEYS, dcgan_init
    from fdgan_tpu_torch.train.loop import create_train_state, make_gd_steps, make_train_step
    from fdgan_tpu_torch.train.meters import AverageMeter, MetricLogger, create_exp_dir
    from fdgan_tpu_torch.train.pool import ImagePool

    print(opt)
    refuse(opt)
    nprocs, pid = mesh.world_size(), mesh.rank()
    is_main = pid == 0
    n_sp = opt.spatialShards
    if nprocs % n_sp:
        raise SystemExit(f"--spatialShards {n_sp} must divide the {nprocs} processes")
    n_data = nprocs // n_sp
    local_batch = opt.batchSize // n_data  # == batchSize single-process
    if nprocs > 1:
        if opt.batchSize % n_data:
            raise SystemExit(f"--batchSize {opt.batchSize} (global) must divide by the {n_data} data shards")
        print(f"multi-process: {nprocs} processes x 1 local devices = {nprocs} global; this is process {pid}")
    sp_mesh = rows = None
    if n_sp > 1:
        sp_mesh = mesh.make_mesh(n_data, n_sp, device_type=device.type)
        rows = slice(*mesh.spatial_rows(opt.imageSize, n_sp)[sp_mesh.get_coordinate()[1]])
        print(f"spatial sharding: H axis over {n_sp} processes (mesh {n_data}x{n_sp}); this process holds rows "
              f"{rows.start}:{rows.stop}")
    if opt.keepBest and (val_loader is None or not opt.evalIter):
        raise SystemExit("--keepBest needs --valDataroot and a nonzero --evalIter (best-model selection is by "
                         "val PSNR)")
    if opt.debugNans:
        torch.autograd.set_detect_anomaly(True)
    create_exp_dir(opt.exp)
    state, tx_g, tx_d = create_train_state(
        opt.seed, lr_g=opt.lrG, lr_d=opt.lrD, beta1=opt.beta1,
        decay_every=opt.annealEvery if opt.annealStart else 0, decay_start=opt.annealStart,
        clip_grad=opt.clipGrad, device=device,
    )
    if opt.dcganInit:
        # before any resume, so that a loaded checkpoint below still wins
        dcgan_init(state.g, opt.seed, skip=DENSENET_PRETRAINED_KEYS)
        dcgan_init(state.d, opt.seed + 1)
    if opt.netG:
        state.g.load_state_dict(load_generator(opt.netG, device="cpu").state_dict())
    if opt.netD:
        state.d.load_state_dict(load_discriminator(opt.netD, device="cpu").state_dict())
    ckpt = latest_checkpoint(opt.exp) if is_main else None
    if ckpt:
        if ckpt.endswith(".msgpack"):
            load_jax_checkpoint(ckpt, state, tx_g, tx_d)
        else:
            load_checkpoint(ckpt, state)
        print(f"resumed from {ckpt} at step {state.step}")
    mesh.broadcast_state(state)  # rank 0's init or resume on every rank
    group = mesh.process_group()

    vgg = None
    if opt.vggWeights:
        from fdgan_tpu_torch.io.torch_import import load_vgg16

        vgg = load_vgg16(opt.vggWeights, device=device)
    elif opt.lambdaPerceptual > 0 or opt.lambdaCX > 0:
        print("WARNING: --lambdaPerceptual or --lambdaCX > 0 but no --vggWeights given; the perceptual and "
              "contextual losses are OFF. Supply a VGG16 .pth in either the reference's Vgg16 format or stock "
              "torchvision format (io.torch_import.load_vgg16 accepts both).")
    weights = LossWeights(adv=opt.lambdaAdv, pixel=opt.lambdaPixel, pixel_norm=opt.pixelNorm,
                          perceptual=opt.lambdaPerceptual, ssim=opt.lambdaSSIM, contextual=opt.lambdaCX)
    compute_dtype = torch.bfloat16 if opt.precision == "bf16" else torch.float32
    remat = "stages" if opt.rematStages else opt.remat
    use_pool = opt.poolSize > 0
    if use_pool:
        g_step, d_step = make_gd_steps(tx_g, tx_d, weights, vgg, compute_dtype, impl=opt.impl,
                                       real_label=opt.labelSmooth, remat=remat, group=group, mesh=sp_mesh)
        # each process pools its own fakes; with H sharded, its band of them: the pool's seed is the same on
        # every rank, so the ranks of a spatial group draw alike and an image's bands stay together
        pool = ImagePool(opt.poolSize, seed=opt.seed)
    else:
        train_step = make_train_step(tx_g, tx_d, weights, vgg, compute_dtype, impl=opt.impl,
                                     real_label=opt.labelSmooth, remat=remat, accum_steps=opt.accumSteps,
                                     group=group, mesh=sp_mesh)

    # the other processes run the same steps and write nothing
    logger = MetricLogger(os.path.join(opt.exp, "train_log.jsonl"), opt.logEvery) if is_main else _NullLogger()
    meter = AverageMeter()
    best = {"psnr": float("-inf"), "state": None, "step": 0}
    best_path = os.path.join(opt.exp, "netG_best.pth")
    if is_main and opt.keepBest and os.path.exists(best_path + ".json"):
        # resuming into an exp dir that already holds a best: its PSNR is the bar
        with open(best_path + ".json") as f:
            prev = json.load(f)
        best.update(psnr=prev["psnr"], step=prev["step"])
        print(f"existing best kept as the bar: {prev['psnr']:.2f} dB @ {prev['step']}")

    def run_eval():
        v_psnr, v_ssim = evaluate(state.g, val_loader, device, opt.impl)
        logger.log(state.step, {"val_psnr": v_psnr, "val_ssim": v_ssim})
        if opt.keepBest and v_psnr > best["psnr"]:
            # the step updates G in place: keep copies, not the live tensors
            best.update(psnr=v_psnr, step=state.step,
                        state={k: v.detach().clone() for k, v in state.g.state_dict().items()})

    def save_best():
        if best["state"] is None or best.get("saved"):
            return
        best["saved"] = True
        torch.save(best["state"], best_path + ".tmp")
        os.replace(best_path + ".tmp", best_path)
        with open(best_path + ".json", "w") as f:
            json.dump({"psnr": best["psnr"], "step": best["step"]}, f)
        print(f"best generator (val PSNR {best['psnr']:.2f} @ step {best['step']}) -> {best_path}")

    def save_best_at_exit():
        # a crashed or interrupted run must not lose the tracked best
        try:
            save_best()
        except Exception as e:  # the exp dir gone, the card lost
            print(f"keepBest: could not save at exit: {e}")

    if opt.keepBest:
        atexit.register(save_best_at_exit)
    evaluating = is_main and val_loader is not None and opt.evalIter  # no collective: rank 0 alone
    if evaluating:
        run_eval()  # step-0 baseline, so that the logged val trend stands alone

    t_log = time.time()
    for epoch in range(opt.epochs):
        t_epoch = time.time()
        for haze, gt in loader:
            if haze.shape[0] % opt.accumSteps or (nprocs > 1 and haze.shape[0] != local_batch):
                # a ragged final batch the microbatches do not divide, or a ragged local batch (the same
                # skip on every process: the shards are equal and share the shuffle's seed)
                continue
            if rows is not None:  # this rank's band of its data group's images
                haze, gt = haze[:, rows], gt[:, rows]
            haze_t = torch.from_numpy(np.ascontiguousarray(haze, np.float32)).to(device)
            gt_t = torch.from_numpy(np.ascontiguousarray(gt, np.float32)).to(device)
            if use_pool:
                state, metrics, x_hat = g_step(state, haze_t, gt_t)
                state, d_metrics = d_step(state, pool.query(x_hat), gt_t)
                metrics.update(d_metrics)
            else:
                state, metrics = train_step(state, haze_t, gt_t)
            if state.step % opt.logEvery == 0:
                # the metrics are 0-d device tensors: read them only here, since
                # a read waits for the step
                m = {k: float(v) for k, v in metrics.items()}
                # the global batch's images: the local images times the data shards
                m["imgs_per_sec"] = haze.shape[0] * n_data * opt.logEvery / max(time.time() - t_log, 1e-9)
                t_log = time.time()
                logger.log(state.step, m)
                meter.update(m.get("g_total", 0.0))
            if evaluating and state.step % opt.evalIter == 0:
                run_eval()
        if is_main and ((epoch + 1) % max(opt.ckptEvery, 1) == 0 or epoch == opt.epochs - 1):
            save_checkpoint(opt.exp, state, step=state.step)
        if is_main:
            print(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s; avg g_loss {meter.avg:.4f}")
    save_best()
    if opt.keepBest:
        atexit.unregister(save_best_at_exit)
    logger.close()
    return state


def main(argv=None):
    opt = build_parser().parse_args(argv)
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device; pass --device cpu to run on the CPU")
    refuse(opt)  # before a process group is joined
    mesh.maybe_init_distributed(device)
    nprocs = mesh.world_size()
    if nprocs > 1 and device.type == "cuda":
        device = mesh.local_device()
        torch.cuda.set_device(device)
    from fdgan_tpu_torch.data import get_loader

    # each data group its own shard, with the same seed: the shards stay step-aligned, and the ranks of a
    # spatial group load the same images
    n_data = nprocs // opt.spatialShards
    loader = get_loader(opt.dataset, opt.dataroot, opt.originalSize, opt.imageSize,
                        batch_size=opt.batchSize // max(n_data, 1), workers=opt.workers, split="train",
                        shuffle=True, seed=opt.seed,
                        shard=(mesh.rank() // opt.spatialShards, n_data) if n_data > 1 else None)
    val_loader = None
    if opt.valDataroot:
        val_loader = get_loader(opt.dataset, opt.valDataroot, opt.imageSize, opt.imageSize, batch_size=1,
                                workers=1, split="val", shuffle=False)
    return train(opt, loader, val_loader, device)


if __name__ == "__main__":
    main()
