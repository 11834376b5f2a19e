"""Checkpoint names and layouts for the port.

The port's state dicts ARE the reference's: ``netG_epoch_*.pth`` files load
into :class:`~fdgan_tpu_torch.models.fdgan.FDGAN` with
``load_state_dict(strict=True)`` once the DataParallel ``module.`` prefix
and the ``num_batches_tracked`` counters are gone
(:func:`load_torch_state_dict`). The module names are the JAX trees' paths.
The reference's blockUNet layers (dehaze22.py:35-60, dehaze1113.py:201-207)
were built with dotted ``add_module`` names, so its ``.pth`` keys double a
segment (``dlayer8.dlayer8.tconv.weight``): :func:`reference_state_dict`
collapses them on import and :func:`export_state_dict` writes them again
(``fdgan_tpu/io/torch_import.py:194-248``).

:func:`model_registry` lists the ten checkpointable families of
``fdgan_tpu/io/torch_import.py:287-309``, each with its ConvTranspose2d
modules (the ``*_TRANSPOSED`` sets, stored IOHW by torch) and its doubled
paths (``*_DUPLICATED``).

:func:`state_dict_from_jax` carries a JAX parameter tree (nested dicts, as
numpy arrays) across: HWIO kernels become OIHW, or IOHW for the modules of
``transposed``, and BN scale/bias/mean/var become
weight/bias/running_mean/running_var. :func:`jax_leaves` is the other
direction, leaf by leaf in JAX's flatten order, for the params files of
``io/checkpoint.py``.

:func:`load_vgg16` reads a VGG16 ``.pth`` for the perceptual loss in either
naming, as ``convert_vgg16`` does (``fdgan_tpu/io/torch_import.py:157-191``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fdgan_tpu_torch.models.vgg16 import _CFG, VGG16
from fdgan_tpu_torch.nn.layers import BatchNorm

# torchvision vgg16's Sequential indices of the 13 convs, in models/vgg16.py's _CFG order
_TORCHVISION_VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

# ConvTranspose2d modules of the FDGAN generator (TransitionBlockdy conv1s,
# dehaze1113.py:343-428)
FDGAN_TRANSPOSED = frozenset({"trans_block4.conv1", "trans_block5.conv1", "trans_block6.conv1"})
# the U-Nets' blockUNet(transposed=True) decoder (dehaze22.py:245-289); dlayer8 … dlayer5
# have equal in and out channels, so no shape tells the two layouts apart
UNET_TRANSPOSED = frozenset({f"dlayer{i}.tconv" for i in range(1, 9)})
# the 1×1 ConvTranspose2d of the Dense/Dense2 decoder's transitions (dehaze1113.py:447-477, :588-618)
DENSE_G_TRANSPOSED = frozenset({f"trans_block{i}.conv1" for i in range(4, 9)})
DEHAZE_TRANSPOSED = frozenset(
    {f"tran_est.{p}" for p in UNET_TRANSPOSED}
    | {f"atp_est.{p}" for p in UNET_TRANSPOSED}
    | {f"tran_dense.{p}" for p in DENSE_G_TRANSPOSED}
)
# densenet_dehaze's decoder transitions (no registry family: the reference never shipped one)
DENSENET_DEHAZE_TRANSPOSED = frozenset({f"trans_block{i}.conv1" for i in range(5, 9)})
# paths whose reference keys double their last segment
UNET_DUPLICATED = frozenset({f"layer{i}" for i in range(1, 9)} | {f"dlayer{i}" for i in range(1, 9)})
DEHAZE_DUPLICATED = frozenset({f"tran_est.{p}" for p in UNET_DUPLICATED} | {f"atp_est.{p}" for p in UNET_DUPLICATED})
PATCHD_DUPLICATED = frozenset({"main.layer2", "main.layer3"})


class Family(NamedTuple):
    """A checkpointable model family: ``build(device, dtype)`` makes the
    module (seed-0 weights), ``transposed`` and ``duplicated`` as above."""

    build: Callable[..., nn.Module]
    transposed: frozenset
    duplicated: frozenset


def model_registry() -> Dict[str, Family]:
    """Family name → :class:`Family`, for the ten families of the JAX
    package's ``model_registry`` and ``cli/convert``'s ``--model``."""
    from fdgan_tpu_torch.models import dcpdn, discriminators
    from fdgan_tpu_torch.models.fdgan import FDGAN

    none = frozenset()
    return {
        "fdgan": Family(FDGAN, FDGAN_TRANSPOSED, none),
        "vgg16": Family(VGG16, none, none),
        "dense": Family(lambda **kw: dcpdn.DenseG(pyramid=False, **kw), DENSE_G_TRANSPOSED, none),
        "dense2": Family(lambda **kw: dcpdn.DenseG(pyramid=True, **kw), DENSE_G_TRANSPOSED, none),
        "unetg": Family(dcpdn.UNetG, UNET_TRANSPOSED, UNET_DUPLICATED),
        "unetg2": Family(dcpdn.UNetG2, UNET_TRANSPOSED, UNET_DUPLICATED),
        "dehaze": Family(dcpdn.DehazePhysical, DEHAZE_TRANSPOSED, DEHAZE_DUPLICATED),
        "nlayer": Family(discriminators.NLayerDiscriminator, none, none),
        "patchd": Family(discriminators.PatchD, none, PATCHD_DUPLICATED),
        "begand": Family(discriminators.BeganD, none, none),
    }


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


def state_dict_from_jax(tree: Mapping, transposed: frozenset = FDGAN_TRANSPOSED) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (nested dicts of numpy arrays) → the port's
    state dict, with torch's names and layouts; ``transposed`` is the
    family's set of ConvTranspose2d paths."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: str) -> None:
        if "kernel" in node:
            k = np.asarray(node["kernel"])
            # HWIO → IOHW (ConvTranspose2d) or OIHW (Conv2d)
            order = (2, 3, 0, 1) if path.rstrip(".") in transposed else (3, 2, 0, 1)
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


def _vgg16_names(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision's ``features.N.*`` keys → the reference's ``conv1_1.*``
    names (``classifier.*`` dropped); other state dicts as they are."""
    if not any(k.startswith("features.") for k in state):
        return state
    names = {str(i): cfg[0] for i, cfg in zip(_TORCHVISION_VGG16_CONVS, _CFG)}
    return {f"{names[k.split('.')[1]]}.{k.split('.')[2]}": v for k, v in state.items()
            if k.startswith("features.") and k.split(".")[1] in names}


def load_vgg16(path: str, device="cuda", dtype=torch.float32):
    """A :class:`~fdgan_tpu_torch.models.vgg16.VGG16` on ``device`` from a
    ``.pth`` in the reference's ``Vgg16`` names (``conv1_1.weight`` …) or in
    torchvision's ``vgg16`` layout (``features.N.weight`` …, whose
    ``classifier.*`` is dropped), loaded strictly."""
    vgg = VGG16(device=device, dtype=dtype)
    vgg.load_state_dict(_vgg16_names(load_torch_state_dict(path)), strict=True)
    return vgg


def reference_state_dict(path: str, model: nn.Module, key: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict (:func:`load_torch_state_dict`) under ``model``'s
    names: a key ``model`` lacks has its consecutive repeated segments
    collapsed (``main.layer2.layer2.conv.weight`` → ``main.layer2.conv.weight``),
    as the JAX import does (``fdgan_tpu/io/torch_import.py:96-102``), and a
    torchvision VGG16 is renamed. ``model.load_state_dict(..., strict=True)``
    then names whatever is still missing or unexpected."""
    state = load_torch_state_dict(path, key=key)
    if isinstance(model, VGG16):
        state = _vgg16_names(state)
    live = model.state_dict()
    out = {}
    for k, v in state.items():
        if k not in live:
            parts = k.split(".")
            k = ".".join(p for i, p in enumerate(parts) if i == 0 or p != parts[i - 1])
        out[k] = v
    return out


def export_state_dict(state: Mapping[str, torch.Tensor], prefix: str = "",
                      duplicated: frozenset = frozenset()) -> Dict[str, torch.Tensor]:
    """The port's state dict as the reference's ``.pth`` keys: each key under
    a path of ``duplicated`` gets that path's last segment doubled
    (``dlayer8.tconv.weight`` → ``dlayer8.dlayer8.tconv.weight``), then
    ``prefix`` (``module.`` for DataParallel) goes in front."""
    dup = [tuple(p.split(".")) for p in sorted(duplicated)]
    out = {}
    for k, v in state.items():
        parts = k.split(".")
        for d in dup:
            if len(parts) > len(d) and tuple(parts[:len(d)]) == d:
                parts = list(d) + [d[-1]] + parts[len(d):]
                break
        out[prefix + ".".join(parts)] = v
    return out


_JAX_LEAF = {"bias": "bias", "running_mean": "mean", "running_var": "var"}


def jax_leaves(model: nn.Module, transposed: frozenset) -> List[Tuple[str, str]]:
    """(JAX path, state-dict key) of every parameter and buffer of ``model``
    in JAX's flatten order of the family's tree: a 4-D ``weight`` is the
    ``kernel``, a BatchNorm's ``weight`` its ``scale``, and
    ``running_mean`` / ``running_var`` are ``mean`` / ``var``. JAX sorts a
    dict's keys at each level of nesting: the order of the paths' segment
    tuples, not of the dotted strings."""
    out = []
    for key, t in model.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        if leaf == "weight":
            leaf = "kernel" if t.dim() == 4 else "scale"
            if leaf == "scale" and not isinstance(model.get_submodule(mod), BatchNorm):
                raise ValueError(f"{key}: a 1-D weight outside a BatchNorm has no JAX leaf")
        else:
            leaf = _JAX_LEAF[leaf]
        out.append((f"{mod}.{leaf}", key))
    return sorted(out, key=lambda pk: pk[0].split("."))


def to_jax_layout(t: torch.Tensor, module_path: str, transposed: frozenset) -> torch.Tensor:
    """A port tensor in its JAX leaf's layout: a 4-D weight to HWIO from
    OIHW, or from IOHW for a path of ``transposed``; anything else as it is."""
    if t.dim() != 4:
        return t
    return t.permute(2, 3, 0, 1) if module_path in transposed else t.permute(2, 3, 1, 0)


def from_jax_layout(t: torch.Tensor, module_path: str, transposed: frozenset) -> torch.Tensor:
    """The inverse of :func:`to_jax_layout`."""
    if t.dim() != 4:
        return t
    return t.permute(2, 3, 0, 1) if module_path in transposed else t.permute(3, 2, 0, 1)
