"""Train-state checkpoints: G, D, both Adams and the update counts.

Counterpart of ``fdgan_tpu/io/checkpoint.py`` (``save_checkpoint``,
``load_checkpoint``, ``latest_checkpoint``) in the port's own format: one
``torch.save`` file ``ckpt_{step}.pt`` holding

- ``g`` and ``d``: the two state dicts under the reference's ``.pth`` names,
  so ``g`` alone is a loadable ``netG`` (``cli._common.load_generator``);
- ``g_opt`` and ``d_opt``: the two Adam state dicts;
- ``step`` and ``d_updates``: ``TrainState``'s counts, at which the
  learning-rate schedules are evaluated.

Files are written atomically (``path + ".tmp"``, then ``os.replace``) and
read with ``weights_only=True``. A load checks every tensor's name, shape and
dtype against the live state first, as the JAX ``load_checkpoint`` checks
its leaves (``:97-126``). Not ported: ``AsyncCheckpointer`` (ROADMAP.md).

:func:`save_params` and :func:`load_params` write and read one model in the
JAX package's own params file, a ``.msgpack`` (``fdgan_tpu/io/checkpoint.py
:21-34``): the ``netG_best.msgpack`` of the JAX training CLI, its ``--netD``
and the JAX ``cli/convert``'s output. The leaves are the model's tensors in
JAX's flatten order and layouts (``io/torch_import.py::jax_leaves``), coded
by ``io/msgpack.py``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Mapping, Optional

import torch
from torch import nn

from fdgan_tpu_torch.io import msgpack
from fdgan_tpu_torch.io.torch_import import from_jax_layout, jax_leaves, to_jax_layout

_CKPT = re.compile(r"ckpt_(\d+)\.pt$")


def save_checkpoint(path: str, state, step: Optional[int] = None) -> str:
    """Write ``state`` (a ``train.loop.TrainState``) to ``path``, or to
    ``path/ckpt_{step}.pt`` when ``step`` is given and ``path`` is not a
    ``.pt`` file. Returns the file's path."""
    if step is not None and not path.endswith(".pt"):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, f"ckpt_{step}.pt")
    blob = {"g": state.g.state_dict(), "d": state.d.state_dict(),
            "g_opt": state.g_opt.state_dict(), "d_opt": state.d_opt.state_dict(),
            "step": int(state.step), "d_updates": int(state.d_updates)}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def _check(what: str, saved: Mapping[str, torch.Tensor], live: Mapping[str, torch.Tensor]) -> None:
    if set(saved) != set(live):
        missing, extra = sorted(set(live) - set(saved)), sorted(set(saved) - set(live))
        raise ValueError(f"checkpoint {what}: missing {missing[:8]}, unexpected {extra[:8]}")
    for name, t in saved.items():
        want = live[name]
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint {what} {name} has shape {tuple(t.shape)}, target expects "
                             f"{tuple(want.shape)}: wrong model or configuration for this checkpoint?")
        if t.dtype != want.dtype:
            raise ValueError(f"checkpoint {what} {name} has dtype {t.dtype}, target expects {want.dtype}")


def _check_opt(what: str, saved: dict, opt: torch.optim.Optimizer) -> None:
    """Adam keys its state by parameter index: each moment must have its
    parameter's shape and dtype."""
    params = [p for group in opt.param_groups for p in group["params"]]
    if sum(len(g["params"]) for g in saved["param_groups"]) != len(params):
        raise ValueError(f"checkpoint {what}: {sum(len(g['params']) for g in saved['param_groups'])} "
                         f"parameters, target expects {len(params)}")
    for idx, entry in saved["state"].items():
        _check(f"{what} state[{idx}]", {k: v for k, v in entry.items() if k != "step"},
               {k: params[idx] for k in entry if k != "step"})


def load_checkpoint(path: str, state):
    """Restore ``state`` (a ``TrainState`` of the same model) in place from
    ``path`` and return it. Raises ``ValueError`` naming the first tensor
    whose name, shape or dtype differs from the live state's."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    _check("g", blob["g"], state.g.state_dict())
    _check("d", blob["d"], state.d.state_dict())
    _check_opt("g_opt", blob["g_opt"], state.g_opt)
    _check_opt("d_opt", blob["d_opt"], state.d_opt)
    state.g.load_state_dict(blob["g"], strict=True)
    state.d.load_state_dict(blob["d"], strict=True)
    state.g_opt.load_state_dict(blob["g_opt"])
    state.d_opt.load_state_dict(blob["d_opt"])
    state.step, state.d_updates = int(blob["step"]), int(blob["d_updates"])
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``ckpt_{step}.pt`` of ``ckpt_dir`` with the highest step, or None."""
    paths = [p for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*.pt")) if _CKPT.search(p)]
    if not paths:
        return None
    return max(paths, key=lambda p: int(_CKPT.search(p).group(1)))


def save_params(path: str, model: nn.Module, transposed: frozenset) -> str:
    """Write ``model``'s parameters and buffers to ``path`` as the JAX
    package's params file; ``transposed`` is the family's set of
    ConvTranspose2d paths. Atomic, as :func:`save_checkpoint`."""
    state = model.state_dict()
    leaves = [to_jax_layout(state[key], key.rsplit(".", 1)[0], transposed).contiguous()
              for _, key in jax_leaves(model, transposed)]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.pack_leaves(leaves))
    os.replace(tmp, path)
    return path


@torch.no_grad()
def load_params(path: str, model: nn.Module, transposed: frozenset) -> nn.Module:
    """Read a JAX params file into ``model`` in place and return it. Every
    leaf's shape and dtype is checked against the model's tensor first, in
    order, and the first mismatch raises ``ValueError`` naming the leaf's
    JAX path (as the JAX ``load_checkpoint`` names it): a file of another
    family or configuration fails there, or, where every leaf fits, on the
    count of leaves."""
    order = jax_leaves(model, transposed)
    with open(path, "rb") as f:
        leaves = msgpack.unpack_leaves(f.read(), [p for p, _ in order])
    state = model.state_dict()
    loaded = {}
    for (jpath, key), leaf in zip(order, leaves):
        want = to_jax_layout(state[key], key.rsplit(".", 1)[0], transposed)
        if tuple(leaf.shape) != tuple(want.shape):
            raise ValueError(f"{path}: leaf {jpath} has shape {tuple(leaf.shape)}, the model expects "
                             f"{tuple(want.shape)}: wrong model family or configuration?")
        if leaf.dtype != want.dtype:
            raise ValueError(f"{path}: leaf {jpath} has dtype {leaf.dtype}, the model expects {want.dtype}")
        loaded[key] = from_jax_layout(leaf, key.rsplit(".", 1)[0], transposed)
    if len(leaves) != len(order):
        raise ValueError(f"{path}: {len(leaves)} leaves, the model expects {len(order)}: wrong model family?")
    model.load_state_dict(loaded, strict=True)
    return model
