"""Shared CLI helpers: model loading (any registry family, from a ``.pth``
or a JAX ``.msgpack``), the reference's PNG output, fp32 without TF32, and
the profiler context.

Counterpart of ``fdgan_tpu/cli/_common.py``. Not ported:
``enable_compile_cache``, since eager PyTorch compiles nothing per shape.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch


def save_image_normalized(arr_hwc: np.ndarray, path: str) -> None:
    """``vutils.save_image(..., normalize=True, scale_each=False)`` semantics
    (demo.py:151): min/max-normalise to [0, 1], then write 8-bit."""
    from PIL import Image

    from fdgan_tpu_torch.utils.images import normalize_to_uint8

    Image.fromarray(normalize_to_uint8(arr_hwc)).save(path)


def _check_format(path: str) -> bool:
    """True for a JAX params file (``.msgpack``), False for a ``.pth`` or
    ``.pt``; anything else raises."""
    if path.endswith(".msgpack"):
        return True
    if path.endswith((".pth", ".pt")):
        return False
    raise ValueError(f"{path}: the port loads .pth, .pt and .msgpack checkpoints only")


def load_model(path: str, family: str, device="cuda", dtype=torch.float32, key: Optional[str] = None):
    """A model of registry ``family`` (``io.torch_import.model_registry``) on
    ``device`` in ``dtype``, from a reference ``.pth`` (DataParallel
    prefixes and doubled blockUNet segments handled; torchvision names for
    ``vgg16``; the entry ``key`` of a train checkpoint ``ckpt_{step}.pt``)
    or from the JAX package's params ``.msgpack``, whose leaves must be
    fp32 as JAX writes them. The floating parameters and buffers are cast
    to ``dtype`` as they load."""
    from fdgan_tpu_torch.io.checkpoint import load_params
    from fdgan_tpu_torch.io.torch_import import model_registry, reference_state_dict

    registry = model_registry()
    if family not in registry:
        raise KeyError(f"unknown model family {family!r}; choose from {sorted(registry)}")
    fam = registry[family]
    if _check_format(path):
        model = load_params(path, fam.build(device="cpu"), fam.transposed)
        return model.to(device=device, dtype=dtype)
    model = fam.build(device=device, dtype=dtype)
    model.load_state_dict(reference_state_dict(path, model, key=key), strict=True)
    return model


def load_generator(path: str, device="cuda", dtype=torch.float32):
    """An FDGAN generator on ``device`` in ``dtype`` from a reference
    ``.pth`` checkpoint (DataParallel prefixes handled), from the ``g`` of
    a train checkpoint ``ckpt_{step}.pt`` (``io/checkpoint.py``), or from a
    JAX params ``.msgpack`` (``netG_best.msgpack``, ``cli/convert``'s
    output). The floating parameters and buffers are cast to ``dtype`` as
    they load."""
    return load_model(path, "fdgan", device, dtype, key="g")


def load_discriminator(path: str, device="cuda", dtype=torch.float32):
    """The fusion discriminator ``NLayerDiscriminator(input_nc=9)`` on
    ``device`` from a ``.pth`` state dict (``--netD``), from the ``d`` of a
    train checkpoint, or from a JAX params ``.msgpack``."""
    return load_model(path, "nlayer", device, dtype, key="d")


def fp32_exact(precision: str, device):
    """fp32 runs cuDNN and matmuls without TF32: the counterpart of the JAX
    CLIs' ``jax_default_matmul_precision="highest"`` (demo.py:60-65,
    train.py:148-150). Does nothing for bf16 or off the card."""
    if precision != "fp32" or torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.backends.cudnn.flags(enabled=True, allow_tf32=False))
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    stack.callback(setattr, torch.backends.cuda.matmul, "allow_tf32", allow)
    return stack


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str]):
    """``torch.profiler`` over the host and, where there is a card, the
    device; the Chrome trace is written to ``profile_dir/trace.json``. The
    upgrade over the reference's bare wall-clock prints (demo.py:131-135).
    Does nothing when ``profile_dir`` is empty."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
