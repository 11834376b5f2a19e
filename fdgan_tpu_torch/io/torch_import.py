"""Checkpoint loading for the port.

The port's state dict IS the reference's: ``netG_epoch_*.pth`` files load
into :class:`~fdgan_tpu_torch.models.fdgan.FDGAN` with
``load_state_dict(strict=True)`` once the DataParallel ``module.`` prefix
and the ``num_batches_tracked`` counters are gone
(:func:`load_torch_state_dict`).

:func:`state_dict_from_jax` carries a JAX parameter tree (``fdgan.init``'s
nested dicts, as numpy arrays) across: HWIO kernels become OIHW, or IOHW
for the ConvTranspose2d modules, and BN scale/bias/mean/var become
weight/bias/running_mean/running_var. It is
``fdgan_tpu.io.torch_import.export_state_dict`` without jax.

:func:`load_vgg16` reads a VGG16 ``.pth`` for the perceptual loss in either
naming, as ``convert_vgg16`` does (``fdgan_tpu/io/torch_import.py:157-191``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from fdgan_tpu_torch.models.vgg16 import _CFG, VGG16

# torchvision vgg16's Sequential indices of the 13 convs, in models/vgg16.py's _CFG order
_TORCHVISION_VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

# ConvTranspose2d modules of the FDGAN generator (TransitionBlockdy conv1s,
# dehaze1113.py:343-428)
FDGAN_TRANSPOSED = frozenset({"trans_block4.conv1", "trans_block5.conv1", "trans_block6.conv1"})


def load_torch_state_dict(path: str, key: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Read a .pth state dict onto the CPU, stripping DataParallel's
    ``module.`` prefix and dropping ``num_batches_tracked``. Where the file
    is a train checkpoint (``io/checkpoint.py``) and ``key`` is given, the
    state dict is its entry ``key`` (``"g"`` or ``"d"``)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if key is not None and isinstance(state.get(key), dict):
        state = state[key]
    out = {}
    for k, v in state.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.rsplit(".", 1)[-1] == "num_batches_tracked":
            continue
        out[k] = v.detach()
    return out


def state_dict_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (nested dicts of numpy arrays) → the port's
    state dict, with torch's names and layouts."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: str) -> None:
        if "kernel" in node:
            k = np.asarray(node["kernel"])
            # HWIO → IOHW (ConvTranspose2d) or OIHW (Conv2d)
            order = (2, 3, 0, 1) if path.rstrip(".") in FDGAN_TRANSPOSED else (3, 2, 0, 1)
            flat[path + "weight"] = torch.from_numpy(np.array(k.transpose(order), order="C"))
            if "bias" in node:
                flat[path + "bias"] = torch.from_numpy(np.array(node["bias"]))
        elif "scale" in node:
            for src, dst in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var")):
                flat[path + dst] = torch.from_numpy(np.array(node[src]))
        else:
            for name, child in node.items():
                walk(child, f"{path}{name}.")

    walk(tree, "")
    return flat


def load_vgg16(path: str, device="cuda", dtype=torch.float32):
    """A :class:`~fdgan_tpu_torch.models.vgg16.VGG16` on ``device`` from a
    ``.pth`` in the reference's ``Vgg16`` names (``conv1_1.weight`` …) or in
    torchvision's ``vgg16`` layout (``features.N.weight`` …, whose
    ``classifier.*`` is dropped), loaded strictly."""
    state = load_torch_state_dict(path)
    if any(k.startswith("features.") for k in state):
        names = {str(i): cfg[0] for i, cfg in zip(_TORCHVISION_VGG16_CONVS, _CFG)}
        state = {f"{names[k.split('.')[1]]}.{k.split('.')[2]}": v for k, v in state.items()
                 if k.startswith("features.") and k.split(".")[1] in names}
    vgg = VGG16(device=device, dtype=dtype)
    vgg.load_state_dict(state, strict=True)
    return vgg
