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
its leaves (``:97-126``).

:class:`AsyncCheckpointer` (JAX's, ``:37-94``) writes a checkpoint from a
background thread while training goes on: one write in flight, the
writer's errors raised on the next ``wait()`` or ``save()``, an atomic
``os.replace``. Where JAX's hazard is the next dispatch donating the
state's buffers, here it is Adam updating the live parameters in place:
``save()`` first takes a copy of every tensor of the state on the device,
on the current stream, and only that copy crosses to the host, on a stream
of the writer's own, after the copy's event.

:func:`save_params` and :func:`load_params` write and read one model in the
JAX package's own params file, a ``.msgpack`` (``fdgan_tpu/io/checkpoint.py
:21-34``): the ``netG_best.msgpack`` of the JAX training CLI, its ``--netD``
and the JAX ``cli/convert``'s output. The leaves are the model's tensors in
JAX's flatten order and layouts (``io/torch_import.py::jax_leaves``), coded
by ``io/msgpack.py``.

:func:`save_jax_checkpoint` and :func:`load_jax_checkpoint` write and read
the JAX training CLI's own checkpoint, ``ckpt_{step}.msgpack``: the leaves of
the whole JAX ``TrainState`` (``fdgan_tpu/train/loop.py:38-43``) in its
flatten order, so that a run moves between the packages in mid-training.
That order is ``step``; G's params; D's params; then per optimiser (G's,
then D's) ``scale_by_adam``'s ``count``, its ``mu`` tree and its ``nu`` tree
(each in the params' order and layouts), and a second ``count`` only where
the learning rate follows a schedule (``scale_by_schedule``;
``clip_by_global_norm`` holds no leaf). ``mu``/``nu`` are torch Adam's
``exp_avg``/``exp_avg_sq``; the counts are Adam's per-parameter ``step`` and
``TrainState.step`` / ``d_updates``. optax keeps moments for every leaf;
torch Adam only for parameters, and only once one had a gradient: the
moments of the BN statistics (buffers here, whose gradient is 0 in JAX) are
written as zeros and not read, and a parameter without Adam state is
written with zero moments, as optax holds one that never had a gradient.
"""

from __future__ import annotations

import glob
import os
import re
import threading
from typing import List, Mapping, Optional, Tuple

import torch
from torch import nn

from fdgan_tpu_torch.io import msgpack
from fdgan_tpu_torch.io.torch_import import FDGAN_TRANSPOSED, from_jax_layout, jax_leaves, to_jax_layout

_CKPT = re.compile(r"ckpt_(\d+)\.(pt|msgpack)$")
_TRANSPOSED = {"g": FDGAN_TRANSPOSED, "d": frozenset()}  # G's and D's ConvTranspose2d paths


def _blob(state) -> dict:
    """What a checkpoint file holds of ``state`` (the module's docstring):
    the live tensors, not copies."""
    return {"g": state.g.state_dict(), "d": state.d.state_dict(),
            "g_opt": state.g_opt.state_dict(), "d_opt": state.d_opt.state_dict(),
            "step": int(state.step), "d_updates": int(state.d_updates)}


def save_checkpoint(path: str, state, step: Optional[int] = None) -> str:
    """Write ``state`` (a ``train.loop.TrainState``, or the dict of a
    checkpoint file that :class:`AsyncCheckpointer` snapshots) to ``path``,
    or to ``path/ckpt_{step}.pt`` when ``step`` is given and ``path`` is not
    a ``.pt`` file. Returns the file's path."""
    if step is not None and not path.endswith(".pt"):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, f"ckpt_{step}.pt")
    blob = state if isinstance(state, dict) else _blob(state)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object: its writes release the GIL, which a writer thread needs
        torch.save(blob, f)
    os.replace(tmp, path)
    return path


class _Slot:
    """Where a tensor of the flat snapshot goes back: its buffer (device and
    dtype), shape and element count, in the order the tree is walked."""

    __slots__ = ("key", "shape", "numel")

    def __init__(self, t: torch.Tensor):
        self.key, self.shape, self.numel = (t.device, t.dtype), tuple(t.shape), t.numel()


def _tree(v, fn, leaf=torch.Tensor):
    """``fn`` applied to every ``leaf`` of a nest of dicts, lists and tuples,
    in a fixed order."""
    if isinstance(v, leaf):
        return fn(v)
    if isinstance(v, dict):
        return {k: _tree(x, fn, leaf) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_tree(x, fn, leaf) for x in v)
    return v


def _snapshot(blob: dict):
    """(skeleton, flat, event): the checkpoint dict with every tensor
    replaced by a :class:`_Slot`; the tensors copied, on their device and
    on its current stream, into one flat buffer per device and dtype (one
    ``torch.cat`` each: a copy of the state costs the host a few calls, not
    one per tensor); and an event recorded after the device's copies (None
    when every tensor is on the CPU)."""
    parts: dict = {}

    def take(t):
        slot = _Slot(t)
        parts.setdefault(slot.key, []).append(t.detach().reshape(-1))
        return slot

    skeleton = _tree(blob, take)
    flat = {key: torch.cat(ts) for key, ts in parts.items()}
    event = None
    cuda = [device for device, _ in flat if device.type == "cuda"]
    if cuda:
        with torch.cuda.device(cuda[0]):
            event = torch.cuda.Event()
            event.record()
    return skeleton, flat, event


def _to_host(skeleton, flat: dict, event: Optional["torch.cuda.Event"]) -> dict:
    """The checkpoint dict in host memory, every slot a view of its flat
    buffer. Once ``event`` has passed, the device's buffers are copied into
    pinned memory on a stream of their own (the training stream is left
    alone; the thread waits on an event, which synchronises neither a
    stream nor the device)."""
    host = {key: f for key, f in flat.items() if not f.is_cuda}
    on_card = {key: f for key, f in flat.items() if f.is_cuda}
    if on_card:
        device = next(iter(on_card.values())).device
        with torch.cuda.device(device):
            side = torch.cuda.Stream(device)
            side.wait_event(event)
            with torch.cuda.stream(side):
                host |= {key: torch.empty(f.shape, dtype=f.dtype, pin_memory=True).copy_(f, non_blocking=True)
                         for key, f in on_card.items()}
            done = torch.cuda.Event()
            done.record(side)
            done.synchronize()
    offsets = dict.fromkeys(host, 0)

    def place(slot: _Slot):
        at = offsets[slot.key]
        offsets[slot.key] = at + slot.numel
        return host[slot.key][at:at + slot.numel].view(slot.shape)

    return _tree(skeleton, place, _Slot)


class AsyncCheckpointer:
    """Checkpoint writes that overlap training (JAX's ``AsyncCheckpointer``).

    ``save(path, state, step)`` copies every tensor of ``state`` (a
    ``train.loop.TrainState``) on its device, on the current stream, into
    one buffer per device and dtype, and records an event: the training
    that follows updates the live tensors in place, never the copy. A
    background thread then waits for the event, brings the copy to the host
    on a stream of its own and writes it with :func:`save_checkpoint`
    (``.tmp`` and an atomic ``os.replace``, so that a crash mid-write never
    spoils a checkpoint; in the file the tensors of one dtype share one
    storage, with the values a blocking save writes). The copy holds a
    second state's worth of device memory until the write has fetched it.
    The writer holds Python's GIL only between its copies and writes, which
    release it; a host-bound loop still loses that time.

    One write is in flight at a time: ``save()`` first waits for the
    previous one. ``wait()`` before reading the file back or exiting; a
    writer's exception is raised there, or by the next ``save()``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: list = []

    def save(self, path: str, state, step: Optional[int] = None) -> None:
        self.wait()
        skeleton, flat, event = _snapshot(_blob(state))

        def write():
            try:
                save_checkpoint(path, _to_host(skeleton, flat, event), step)
            except BaseException as e:  # raised by the next wait() or save()
                self._err.append(e)

        self._thread = threading.Thread(target=write, name="ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join the write in flight. True when none is left. A join that
        times out keeps the thread's handle (dropping it would let the next
        ``save()`` start a second writer, whose file an older, slower
        ``os.replace`` could overwrite), and returns False: call again."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return False
            self._thread = None
        if self._err:
            raise self._err.pop(0)
        return True


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
    """The checkpoint of ``ckpt_dir`` with the highest step, of the port's
    ``ckpt_{step}.pt`` and the JAX CLI's ``ckpt_{step}.msgpack``, or None."""
    paths = [p for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*")) if _CKPT.search(p)]
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


def jax_train_state_leaves(state, tx_g, tx_d) -> List[Tuple[str, torch.Tensor]]:
    """(JAX path, tensor in its JAX layout) of every leaf of the JAX
    ``TrainState`` that ``state`` (a ``train.loop.TrainState``) and its two
    transforms stand for, in JAX's flatten order (the module's docstring).
    The counts are 0-d int32 tensors; a moment without Adam state is zeros."""
    out = [("step", torch.tensor(state.step, dtype=torch.int32))]
    nets = (("g", state.g, state.g_opt, tx_g, state.step), ("d", state.d, state.d_opt, tx_d, state.d_updates))
    for name, model, _, _, _ in nets:
        transposed, sd = _TRANSPOSED[name], model.state_dict()
        out += [(f"{name}_params.{jpath}", to_jax_layout(sd[key], key.rsplit(".", 1)[0], transposed))
                for jpath, key in jax_leaves(model, transposed)]
    for name, model, opt, tx, count in nets:
        transposed, params, sd = _TRANSPOSED[name], dict(model.named_parameters()), model.state_dict()
        out.append((f"{name}_opt.count", torch.tensor(count, dtype=torch.int32)))
        for moment, key_t in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            for jpath, key in jax_leaves(model, transposed):
                entry = opt.state.get(params[key]) if key in params else None
                t = entry[key_t] if entry else torch.zeros_like(sd[key])
                out.append((f"{name}_opt.{moment}.{jpath}", to_jax_layout(t, key.rsplit(".", 1)[0], transposed)))
        if tx.scheduled:
            out.append((f"{name}_opt.schedule.count", torch.tensor(count, dtype=torch.int32)))
    return out


def save_jax_checkpoint(path: str, state, tx_g, tx_d, step: Optional[int] = None) -> str:
    """Write ``state`` as the JAX training CLI's checkpoint: to ``path``,
    or to ``path/ckpt_{step}.msgpack`` when ``step`` is given and ``path``
    is not a ``.msgpack`` file. ``tx_g`` / ``tx_d`` are the step's
    transforms (whether each holds a schedule's count). Atomic, as
    :func:`save_checkpoint`. Returns the file's path."""
    if step is not None and not path.endswith(".msgpack"):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, f"ckpt_{step}.msgpack")
    leaves = [t.contiguous() for _, t in jax_train_state_leaves(state, tx_g, tx_d)]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.pack_leaves(leaves))
    os.replace(tmp, path)
    return path


@torch.no_grad()
def load_jax_checkpoint(path: str, state, tx_g, tx_d):
    """Restore ``state`` in place from a JAX ``TrainState`` checkpoint and
    return it. Every leaf's shape and dtype is checked against the live
    state's first, in order, and the first mismatch raises ``ValueError``
    naming the leaf's JAX path; so does a leaf count other than the state's
    (another family, another configuration, or a schedule on one side
    only). Every parameter gets Adam state: the file's moments, and its
    optimiser's count as ``step``."""
    order = jax_train_state_leaves(state, tx_g, tx_d)
    with open(path, "rb") as f:
        leaves = msgpack.unpack_leaves(f.read(), [p for p, _ in order])
    for (jpath, want), leaf in zip(order, leaves):
        if tuple(leaf.shape) != tuple(want.shape):
            raise ValueError(f"{path}: leaf {jpath} has shape {tuple(leaf.shape)}, the train state expects "
                             f"{tuple(want.shape)}: wrong model family or configuration?")
        if leaf.dtype != want.dtype:
            raise ValueError(f"{path}: leaf {jpath} has dtype {leaf.dtype}, the train state expects {want.dtype}")
    if len(leaves) != len(order):
        raise ValueError(f"{path}: {len(leaves)} leaves, the train state expects {len(order)}: another model "
                         f"family, or a learning-rate schedule on one side only?")
    file = dict(zip((p for p, _ in order), leaves))
    state.step = int(file["step"])
    nets = (("g", state.g, state.g_opt), ("d", state.d, state.d_opt))
    for name, model, opt in nets:
        transposed = _TRANSPOSED[name]
        loaded = {key: from_jax_layout(file[f"{name}_params.{jpath}"], key.rsplit(".", 1)[0], transposed)
                  for jpath, key in jax_leaves(model, transposed)}
        model.load_state_dict(loaded, strict=True)
        count = int(file[f"{name}_opt.count"])
        params = dict(model.named_parameters())
        for jpath, key in jax_leaves(model, transposed):
            if key not in params:
                continue  # a BN statistic: a buffer here, with no Adam state
            p, mod = params[key], key.rsplit(".", 1)[0]
            opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32)}
            for moment, key_t in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                leaf = from_jax_layout(file[f"{name}_opt.{moment}.{jpath}"], mod, transposed)
                opt.state[p][key_t] = torch.empty_like(p).copy_(leaf)
        if name == "d":
            state.d_updates = count
    return state

