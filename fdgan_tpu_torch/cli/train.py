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
where the loop runs; with no card and no ``--device cpu`` it stops. A run
also resumes from the JAX CLI's ``ckpt_{step}.msgpack`` (a whole
``TrainState``), the newest of both kinds by step.

With ``--valDataroot`` in one process, a val set whose images stack is
staged on the device once and evaluated there (``train/loop.py::
make_device_eval``; two scalars cross to the host an eval), as the JAX CLI
does (``:378-402``); a ragged or too large val set takes the host loop
(:func:`evaluate`).

``--deviceSteps K`` is the JAX CLI's device-resident loop (``:474-614``):
the whole dataset staged on the device, K steps a chunk
(``make_device_loop``, or ``make_device_pool_loop`` with ``--poolSize > 0``)
over a shuffled index sequence (:func:`index_sequence`), the metrics fetched
once a chunk, and checkpoints at epoch boundaries written from a background
thread (``io/checkpoint.AsyncCheckpointer``) unless ``--noAsyncCkpt``:

    python -m fdgan_tpu_torch.cli.train --dataroot ds/ --exp exp/ --imageSize 256 --batchSize 4 \
        --deviceSteps 64 --poolSize 50 --ckptEvery 8 --precision bf16

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
``train/loop.py``'s with the mesh (the contextual term too:
``losses/contextual.py`` gathers the target over the bands). JAX's refusal
of the flag under ``FDGAN_TPU_DIST`` (each process loading whole images)
does not apply here: the ranks of a data group load the same images with the
same seed. One process holds one card, so a single process refuses the
flag; so does an ``--imageSize`` whose bands are too thin for the
discriminator's tail:

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

# what the device-resident loop may stage, as shares of the device's free memory when the loop starts: JAX's
# guards, 6 GB for the dataset and 2 GB for the val set (cli/train.py:389, :506), of a TPU v5e's 16 GB
DATASET_SHARE, VAL_SHARE = 3 / 8, 1 / 8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="pix2pix")
    p.add_argument("--dataroot", default="", help="path to train dataset")
    p.add_argument("--valDataroot", default="",
                   help="val dataset: PSNR/SSIM every --evalIter steps. In one process a val set whose images stack "
                        "and that takes at most 1/8 of the device's free memory is staged on the device once and "
                        "evaluated there (two scalars fetched an eval); else the host loop")
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
                   help="save a checkpoint every N epochs (a final one is always written). --deviceSteps runs "
                        "write it from a background thread while the next chunk trains "
                        "(io/checkpoint.AsyncCheckpointer) unless --noAsyncCkpt")
    p.add_argument("--noAsyncCkpt", action="store_true",
                   help="block training during checkpoint saves instead of writing them from a background thread "
                        "(--deviceSteps runs only; an async save's copy of the state on the device briefly "
                        "doubles the state's device memory)")
    p.add_argument("--deviceSteps", type=int, default=0,
                   help="device-resident training: stage the WHOLE dataset on the device once (in bf16 with "
                        "--precision bf16) and run this many train steps a chunk, each batch read by a "
                        "device-side index and the metrics fetched once a chunk, so that the host never waits "
                        "on the device inside a chunk. The stacked dataset may take at most 3/8 of the device's "
                        "free memory when the loop starts (JAX's 6 GB of a 16 GB TPU). With --poolSize > 0 the "
                        "ImagePool rides along as a buffer on the device. One process only")
    p.add_argument("--spatialShards", type=int, default=1,
                   help="split each image's H axis into bands over this many processes (FDGAN_TPU_DIST); the "
                        "memory lever for large images, with --rematStages")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return p


def refuse(opt: argparse.Namespace) -> None:
    """Stop on a combination of flags that cannot run, before a process
    group is joined."""
    if opt.deviceSteps > 0 and os.environ.get("FDGAN_TPU_DIST"):
        raise SystemExit(DEVICE_STEPS_SINGLE)
    if opt.spatialShards > 1:
        if not os.environ.get("FDGAN_TPU_DIST"):
            raise SystemExit(f"--spatialShards {opt.spatialShards}: each band of an image is one process with its "
                             "own card; launch N x n_data processes under FDGAN_TPU_DIST, e.g. FDGAN_TPU_DIST=1 "
                             f"torchrun --nproc-per-node {opt.spatialShards} -m fdgan_tpu_torch.cli.train ... "
                             f"--spatialShards {opt.spatialShards}")
        check_bands(opt.imageSize, opt.spatialShards)
    if opt.poolSize > 0 and opt.accumSteps > 1:
        raise SystemExit("--accumSteps > 1 requires --poolSize 0 (the ImagePool G/D split does not "
                         "accumulate; it would silently ignore the flag)")


DEVICE_STEPS_SINGLE = ("--deviceSteps stages the dataset on locally-addressable devices and is single-process for now; "
                       "drop it under FDGAN_TPU_DIST")


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


def index_sequence(n_batches: int, epochs: int, chunk: int, seed: int) -> np.ndarray:
    """The batch indices of a ``--deviceSteps`` run in order, the JAX CLI's
    (``:535-540``): a permutation of the staged batches per epoch from
    ``np.random.default_rng(seed + 2)``, concatenated, and padded to a whole
    chunk with further epochs' permutations (a few surplus steps)."""
    rng = np.random.default_rng(seed + 2)
    return np.concatenate([rng.permutation(n_batches) for _ in range(epochs + chunk // n_batches + 1)]).astype(np.int64)


def free_memory(device) -> int:
    """The bytes free on ``device`` now: the card's, or the host's available
    physical memory for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def device_eval(val_loader: Iterable, device, impl: str = "kernels"):
    """``train/loop.py::make_device_eval`` over ``val_loader``'s pairs, staged
    on ``device``; None (the host loop then) when the images do not stack or
    the stacked set would take more than VAL_SHARE of the device's free
    memory, as the JAX CLI's guard (``:384-402``)."""
    from fdgan_tpu_torch.train.loop import make_device_eval

    try:
        vh = np.stack([np.asarray(b[0], np.float32) for b in val_loader])
        vg = np.stack([np.asarray(b[1], np.float32) for b in val_loader])
    except ValueError:  # ragged val shapes: the host loop
        return None
    if vh.nbytes + vg.nbytes > VAL_SHARE * free_memory(device):
        print(f"val set is {(vh.nbytes + vg.nbytes) / 1e9:.1f} GB stacked — using the streaming host eval loop "
              "instead of staging it")
        return None
    return make_device_eval(vh, vg, device, impl)


def _device_steps(opt, loader, state, device, compute_dtype, logger, meter, g_step_d_step, train_step, run_eval):
    """The ``--deviceSteps`` loop (the module's docstring; JAX's
    ``cli/train.py:474-614``): stage, run the chunks, log, evaluate, save.
    Returns the state; the caller saves the best and closes the log."""
    from fdgan_tpu_torch.io.checkpoint import AsyncCheckpointer
    from fdgan_tpu_torch.train.loop import make_device_loop, make_device_pool_loop
    from fdgan_tpu_torch.train.pool import device_pool_init

    batches = [(np.asarray(h, np.float32), np.asarray(g, np.float32)) for h, g in loader
               if h.shape[0] == opt.batchSize]
    if not batches:
        raise SystemExit("no full batches to stage for --deviceSteps")
    # the step casts both inputs to compute_dtype anyway (the same rounding on the host), so a bf16 run stages
    # them cast: half the memory and half the upload
    haze_all = torch.from_numpy(np.stack([h for h, _ in batches])).to(compute_dtype)
    gt_all = torch.from_numpy(np.stack([g for _, g in batches])).to(compute_dtype)
    del batches
    nbytes = haze_all.nbytes + gt_all.nbytes
    budget = DATASET_SHARE * free_memory(device)
    if nbytes > budget:
        raise SystemExit(f"--deviceSteps dataset is {nbytes / 1e9:.1f} GB stacked — too large to stage next to "
                         f"the model (at most 3/8 of the device's free memory, {budget / 1e9:.1f} GB); use the "
                         "streaming path (omit --deviceSteps)")
    K = opt.deviceSteps
    print(f"staging {haze_all.shape[0]} batches ({nbytes / 1e6:.0f} MB) on device; {K} steps/dispatch")
    haze_all, gt_all = haze_all.to(device), gt_all.to(device)
    nb = haze_all.shape[0]
    if g_step_d_step is not None:
        pool_buf, n_filled = device_pool_init(opt.poolSize, haze_all.shape[1:], compute_dtype, device)
        pool_rng = torch.Generator(device=device)
        pool_rng.manual_seed(opt.seed + 3)  # JAX's data_rng, PRNGKey(seed + 3)
        run_pool = make_device_pool_loop(*g_step_d_step, K)
    else:
        run = make_device_loop(train_step, K)
    n_chunks = (opt.epochs * nb + K - 1) // K
    # uploaded once: each chunk's indices are a slice of it on the device, not a copy from the host
    seq = torch.from_numpy(index_sequence(nb, opt.epochs, K, opt.seed)).to(device)
    saver = None if opt.noAsyncCkpt else AsyncCheckpointer()
    last_saved = -1
    for c in range(n_chunks):
        before = state.step
        t_chunk = time.time()
        idx = seq[c * K:(c + 1) * K]
        if g_step_d_step is not None:
            state, pool_buf, n_filled, ms = run_pool(state, pool_buf, n_filled, haze_all, gt_all, idx, pool_rng)
        else:
            state, ms = run(state, haze_all, gt_all, idx)
        names = list(ms)
        values = torch.stack([ms[k].float() for k in names]).cpu().numpy()  # the chunk's one fetch
        # the wall covers the chunk and its fetch; eval and checkpoint I/O below are reported apart
        wall = time.time() - t_chunk
        for j in range(K):
            s = before + j + 1
            if s % opt.logEvery == 0:
                entry = {k: float(values[n, j]) for n, k in enumerate(names)}
                entry["imgs_per_sec"] = K * opt.batchSize / wall
                logger.log(s, entry)
        meter.update(float(values[names.index("g_total")].mean()))
        after = before + K
        if run_eval is not None and after // opt.evalIter > before // opt.evalIter:
            run_eval()
        if after // nb > before // nb:  # crossed an epoch boundary
            if (after // nb) % max(opt.ckptEvery, 1) == 0:
                t_save = time.time()
                if saver is not None:
                    # a copy on the device now; its fetch and write overlap the next chunk
                    saver.save(opt.exp, state, step=after)
                    print(f"ckpt step {after}: snapshot queued in {time.time() - t_save:.1f}s (background write)")
                else:
                    save_checkpoint(opt.exp, state, step=after)
                    print(f"ckpt step {after}: saved in {time.time() - t_save:.1f}s (blocking)")
                last_saved = after
            print(f"epoch {min(after // nb, opt.epochs) - 1} done ({K * opt.batchSize / wall:.1f} img/s "
                  f"device-resident); avg g_loss {meter.avg:.4f}")
    if saver is not None:
        saver.wait()  # a writer's error surfaces before the final save
    if last_saved != state.step:  # an epoch boundary's save of this very step has landed already
        save_checkpoint(opt.exp, state, step=state.step)
    return state


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
        if opt.deviceSteps > 0:
            raise SystemExit(DEVICE_STEPS_SINGLE)
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

    evaluating = is_main and val_loader is not None and opt.evalIter  # no collective: rank 0 alone
    evaluate_fn = device_eval(val_loader, device, opt.impl) if evaluating and nprocs == 1 else None
    if evaluate_fn is None:
        def evaluate_fn(g):
            return evaluate(g, val_loader, device, opt.impl)

    def run_eval():
        v_psnr, v_ssim = evaluate_fn(state.g)
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
    if evaluating:
        run_eval()  # step-0 baseline, so that the logged val trend stands alone
    if opt.deviceSteps > 0:
        state = _device_steps(opt, loader, state, device, compute_dtype, logger, meter,
                              g_step_d_step=(g_step, d_step) if use_pool else None,
                              train_step=None if use_pool else train_step,
                              run_eval=run_eval if evaluating else None)
        save_best()
        if opt.keepBest:
            atexit.unregister(save_best_at_exit)
        logger.close()
        return state

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
