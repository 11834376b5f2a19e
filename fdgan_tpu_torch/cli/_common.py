"""Shared CLI helpers: generator and discriminator loading, the reference's
PNG output, fp32 without TF32, and the profiler context.

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


def _check_pth(path: str) -> None:
    if path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: the port does not read .msgpack checkpoints yet (ROADMAP.md, Queue 1 item 5, "
            "'.msgpack load'); convert it to .pth with `python -m fdgan_tpu.cli.convert`"
        )
    if not (path.endswith(".pth") or path.endswith(".pt")):
        raise ValueError(f"{path}: the port loads .pth checkpoints only")


def load_generator(path: str, device="cuda", dtype=torch.float32):
    """An FDGAN generator on ``device`` in ``dtype`` from a reference
    ``.pth`` checkpoint (DataParallel prefixes handled) or from the ``g`` of
    a train checkpoint ``ckpt_{step}.pt`` (``io/checkpoint.py``). The
    floating parameters and buffers are cast to ``dtype`` as they load."""
    from fdgan_tpu_torch.io.torch_import import load_torch_state_dict
    from fdgan_tpu_torch.models.fdgan import FDGAN

    _check_pth(path)
    model = FDGAN(device=device, dtype=dtype)
    model.load_state_dict(load_torch_state_dict(path, key="g"), strict=True)
    return model


def load_discriminator(path: str, device="cuda", dtype=torch.float32):
    """The fusion discriminator ``NLayerDiscriminator(input_nc=9)`` on
    ``device`` from a ``.pth`` state dict (``--netD``) or from the ``d`` of a
    train checkpoint."""
    from fdgan_tpu_torch.io.torch_import import load_torch_state_dict
    from fdgan_tpu_torch.models.discriminators import NLayerDiscriminator

    _check_pth(path)
    model = NLayerDiscriminator(input_nc=9, device=device, dtype=dtype)
    model.load_state_dict(load_torch_state_dict(path, key="d"), strict=True)
    return model


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
