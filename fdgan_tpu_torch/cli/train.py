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
with the ROADMAP item that holds them.
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
from fdgan_tpu_torch.io.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint

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
    p.add_argument("--spatialShards", type=int, default=1, help="refused: spatial sharding is not ported yet")
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
        raise SystemExit("--spatialShards > 1: spatial sharding is not ported yet (ROADMAP.md, Queue 1 item 11)")
    if os.environ.get("FDGAN_TPU_DIST") == "1":
        raise SystemExit("FDGAN_TPU_DIST=1: multi-process training is not ported yet (ROADMAP.md, Queue 1 "
                         "item 10)")
    if opt.poolSize > 0 and opt.accumSteps > 1:
        raise SystemExit("--accumSteps > 1 requires --poolSize 0 (the ImagePool G/D split does not "
                         "accumulate; it would silently ignore the flag)")


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


def train(opt: argparse.Namespace, loader: Iterable, val_loader: Optional[Iterable] = None, device="cuda"):
    """The loop: ``opt`` is :func:`build_parser`'s namespace; ``loader``
    yields ``(haze, gt)`` batches every epoch, ``val_loader`` (or None) the
    val pairs. ``--precision fp32`` runs it without TF32 on the card, as the
    JAX CLI sets ``"highest"`` (``:148-150``). Returns the final
    ``TrainState``."""
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
    ckpt = latest_checkpoint(opt.exp)
    if ckpt:
        load_checkpoint(ckpt, state)
        print(f"resumed from {ckpt} at step {state.step}")

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
                                       real_label=opt.labelSmooth, remat=remat)
        pool = ImagePool(opt.poolSize, seed=opt.seed)
    else:
        train_step = make_train_step(tx_g, tx_d, weights, vgg, compute_dtype, impl=opt.impl,
                                     real_label=opt.labelSmooth, remat=remat, accum_steps=opt.accumSteps)

    logger = MetricLogger(os.path.join(opt.exp, "train_log.jsonl"), opt.logEvery)
    meter = AverageMeter()
    best = {"psnr": float("-inf"), "state": None, "step": 0}
    best_path = os.path.join(opt.exp, "netG_best.pth")
    if opt.keepBest and os.path.exists(best_path + ".json"):
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
    if val_loader is not None and opt.evalIter:
        run_eval()  # step-0 baseline, so that the logged val trend stands alone

    t_log = time.time()
    for epoch in range(opt.epochs):
        t_epoch = time.time()
        for haze, gt in loader:
            if haze.shape[0] % opt.accumSteps:
                continue  # a ragged final batch the microbatches do not divide
            haze_t = torch.from_numpy(np.asarray(haze, np.float32)).to(device)
            gt_t = torch.from_numpy(np.asarray(gt, np.float32)).to(device)
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
                m["imgs_per_sec"] = haze.shape[0] * opt.logEvery / max(time.time() - t_log, 1e-9)
                t_log = time.time()
                logger.log(state.step, m)
                meter.update(m.get("g_total", 0.0))
            if val_loader is not None and opt.evalIter and state.step % opt.evalIter == 0:
                run_eval()
        if (epoch + 1) % max(opt.ckptEvery, 1) == 0 or epoch == opt.epochs - 1:
            save_checkpoint(opt.exp, state, step=state.step)
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
    from fdgan_tpu_torch.data import get_loader

    loader = get_loader(opt.dataset, opt.dataroot, opt.originalSize, opt.imageSize, batch_size=opt.batchSize,
                        workers=opt.workers, split="train", shuffle=True, seed=opt.seed)
    val_loader = None
    if opt.valDataroot:
        val_loader = get_loader(opt.dataset, opt.valDataroot, opt.imageSize, opt.imageSize, batch_size=1,
                                workers=1, split="val", shuffle=False)
    return train(opt, loader, val_loader, device)


if __name__ == "__main__":
    main()
