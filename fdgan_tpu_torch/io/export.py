"""AOT export: the generator's forward as a ``torch.export`` program, and an
AOTInductor package that serves it without Python.

Counterpart of ``fdgan_tpu/io/export.py``. JAX lowers the jitted forward
once into a self-contained StableHLO payload; here ``torch.export`` traces
``models.fdgan_fast.apply`` (what ``serve.InferenceEngine`` runs) into an
``ExportedProgram`` (``.pt2``, the ``.shlo``'s counterpart), weights
included, which needs no model code to run: loading it imports only
``ops.library``, where the ``fdgan::`` operators are defined.
``export_native_bundle`` compiles that program with AOTInductor into a
package that ``native/aoti_runner.cpp`` serves from C++ (the PJRT runner's
counterpart), with ``native/fdgan_ops.cpp`` registering the same operators
there.

The hand kernels are in the graph as ``fdgan::dense_layer`` (K1, 42 per
forward), ``fdgan::h_stats`` (K2, 42 in batch BN) and
``fdgan::channel_stats`` (45 in bf16 batch BN). The trace runs under
``torch.no_grad``, so the dense blocks keep their concat in one buffer
(``ops/dense.py::dense_block_fused``) and K1 writes each layer's channels
into it in place; the weights' kernel layouts are ordinary tensor ops in
the graph. A program is traced for one device (``device``: ``"cuda"`` by
default, ``"cpu"`` for the tests, whose ops run the kernels' twins).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from fdgan_tpu_torch.cli._common import fp32_exact
from fdgan_tpu_torch.ops import library  # noqa: F401  (the fdgan:: ops a program calls)

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
MAX_POLY_BATCH = 64  # the largest batch a batch-polymorphic program accepts


class _Core(nn.Module):
    """``fdgan_fast.apply`` over the generator's own parameters, in the
    program's dtype, through the kernels."""

    def __init__(self, model: nn.Module, bn_mode: str, dtype):
        super().__init__()
        self.model, self.bn_mode, self.dtype = model, bn_mode, dtype

    def forward(self, x):
        from fdgan_tpu_torch.models import fdgan_fast

        return fdgan_fast.apply(self.model, x.to(self.dtype), bn_mode=self.bn_mode, impl="kernels")


class _Program(nn.Module):
    """The exported function ``f(x)``: the I/O contract around the core,
    the weights the program's own."""

    def __init__(self, core: _Core, io: str):
        super().__init__()
        self.core, self.io = core, io

    def _run(self, x, params=None):
        if self.io == "uint8":
            x = x.float() / 255.0  # the fp32 x/255 the host would do: exact for 8-bit sources
        if params is None:
            y = self.core(x)
        else:
            y = torch.func.functional_call(self.core, {f"model.{k}": v for k, v in params.items()}, (x,))
        if self.io == "uint8":  # quantised in fp32, as serve.InferenceEngine(output="uint8")
            return torch.clamp(torch.round((y.float() + 1.0) * 127.5), 0.0, 255.0).to(torch.uint8)
        return y.float()

    def forward(self, x):
        return self._run(x)


class _UnbakedProgram(_Program):
    """``f(params, x)``: ``params`` a dict of the generator's state
    (parameters and buffers) in the program's dtype."""

    def forward(self, params, x):
        return self._run(x, params)


def _device(device) -> torch.device:
    if isinstance(device, (list, tuple)):
        raise ValueError(f"a torch program is traced for one device, got {device!r}: export once per device")
    if str(device).split(":")[0] not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r} (a TPU program is fdgan_tpu.io.export's)")
    return torch.device(device)


def export_forward(
    model: nn.Module,
    *,
    image_size: int,
    batch: Union[int, str] = 1,
    precision: str = "bf16",
    bn_mode: str = "batch",
    bake_params: bool = True,
    device="cuda",
    io: str = "float32",
) -> torch.export.ExportedProgram:
    """Trace the generator's forward into a ``torch.export.ExportedProgram``.

    The program takes an fp32 NHWC batch ``(batch, image_size, image_size,
    3)`` in [0, 1] and returns the fp32 dehazed batch, the contract of
    ``serve.InferenceEngine``. ``model`` is an ``FDGAN`` (fp32; ``bf16``
    programs run a bf16 copy of it, ``fp32`` ones run in full fp32, and
    their consumers run them with TF32 off: ``cli._common.fp32_exact``).
    With ``bake_params`` the weights are the program's own (``f(x)``);
    without, the program is ``f(params, x)``, ``params`` a dict of the
    generator's state (parameters and buffers) in the program's dtype, so
    that one program serves many checkpoints. ``batch="poly"`` makes the
    leading dimension symbolic (1 to ``MAX_POLY_BATCH``): one program for
    every batch size. ``io="uint8"`` moves ``x/255`` and the quantisation
    ``round((y+1)·127.5)`` clipped to [0, 255] into the program: uint8 in,
    uint8 out."""
    if precision not in _DTYPES:
        raise ValueError(f"precision must be bf16|fp32, got {precision!r}")
    if bn_mode not in ("batch", "running"):
        raise ValueError(f"bn_mode must be batch|running, got {bn_mode!r}")
    if io not in ("float32", "uint8"):
        raise ValueError(f"io must be float32|uint8, got {io!r}")
    poly = isinstance(batch, str)
    if poly and batch != "poly":
        raise ValueError(f"batch must be an int or 'poly', got {batch!r}")
    if image_size % 8:
        raise ValueError(f"image_size must be divisible by 8, got {image_size}")
    dev = _device(device)
    dtype = _DTYPES[precision]
    core = _Core(copy.deepcopy(model).to(device=dev, dtype=dtype).eval(), bn_mode, dtype)
    prog = (_Program if bake_params else _UnbakedProgram)(core, io).eval()
    # a poly program is traced at batch 2: torch specialises a dimension traced at 1
    n = 2 if poly else int(batch)
    x = torch.zeros((n, image_size, image_size, 3), device=dev,
                    dtype=torch.uint8 if io == "uint8" else torch.float32)
    args = (x,) if bake_params else ({k: v.detach() for k, v in core.model.state_dict().items()}, x)
    dynamic = None
    if poly:
        bdim = torch.export.Dim("batch", min=1, max=MAX_POLY_BATCH)
        dynamic = {"x": {0: bdim}} if bake_params else {"params": {k: None for k in args[0]}, "x": {0: bdim}}
    with torch.no_grad(), fp32_exact(precision, dev):
        return torch.export.export(prog, args, dynamic_shapes=dynamic, strict=False)


def save_exported(path: str, exported: torch.export.ExportedProgram) -> int:
    """Write the program to ``path`` (``torch.export.save``); returns its size in bytes."""
    torch.export.save(exported, path)
    return os.path.getsize(path)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Read a program back (``torch.export.load``); run it with
    ``loaded.module()(x)``, or ``loaded.module()(params, x)`` for
    ``bake_params=False`` exports. Needs ``ops.library`` (imported here)
    and no model code."""
    return torch.export.load(path)


def user_inputs(exported: torch.export.ExportedProgram) -> List[torch.Tensor]:
    """The fake tensors of the program's user inputs, in order."""
    from torch.export.graph_signature import InputKind

    names = [s.arg.name for s in exported.graph_signature.input_specs if s.kind == InputKind.USER_INPUT]
    vals = {n.name: n.meta.get("val") for n in exported.graph.nodes if n.op == "placeholder"}
    return [vals[n] for n in names]


def signature_lines(exported: torch.export.ExportedProgram) -> List[str]:
    """The bundle's ``.sig``: ``<u8|f32> <dims...>`` of the program's input,
    then of its output (a fixed-batch program: the runner's buffers are
    static)."""
    (inp,) = user_inputs(exported)
    (out,) = [a.meta["val"] for a in exported.graph.output_node().args[0]]
    return [" ".join([{torch.uint8: "u8", torch.float32: "f32"}[t.dtype]] + [str(int(d)) for d in t.shape])
            for t in (inp, out)]


def export_native_bundle(
    model: nn.Module,
    out_base: str,
    *,
    image_size: int,
    batch: int = 1,
    precision: str = "bf16",
    bn_mode: str = "batch",
    io: str = "uint8",
    device="cuda",
) -> Dict[str, object]:
    """Export what a process without Python needs to serve the generator.

    Three sibling files at ``out_base``:

    - ``.pt2``: the AOTInductor package (``torch._inductor.
      aoti_compile_and_package``) that ``native/aoti_runner.cpp`` loads;
      its ``fdgan::`` calls reach ``native/fdgan_ops.cpp``'s operators
      there (``aoti_runner --ops``), the Python ones in Python;
    - ``.sig``: two text lines ``<u8|f32> <dims...>`` (input, then output),
      as the JAX bundle's, so the runner needs no other parser;
    - ``.ep.pt2``: the ``ExportedProgram`` (the ``.shlo``'s counterpart),
      for cross-checks through ``ArtifactRunner``.

    Returns the paths under ``pt2``, ``sig`` and ``ep``, and ``seconds``:
    the export, compile and save times. A fixed batch only, as JAX's: the
    runner's buffers are static."""
    if batch == "poly" or not isinstance(batch, int):
        raise ValueError("native bundles need a fixed batch (the runner allocates static buffers)")
    t0 = time.perf_counter()
    exported = export_forward(model, image_size=image_size, batch=batch, precision=precision, bn_mode=bn_mode,
                              device=device, io=io)
    t1 = time.perf_counter()
    paths: Dict[str, object] = {"pt2": f"{out_base}.pt2", "sig": f"{out_base}.sig", "ep": f"{out_base}.ep.pt2"}
    from fdgan_tpu_torch.ops.build import cxx

    with fp32_exact(precision, _device(device)):  # the compiler: one whose -fopenmp links
        torch._inductor.aoti_compile_and_package(exported, package_path=paths["pt2"],
                                                 inductor_configs={"cpp.cxx": (None, cxx())})
    t2 = time.perf_counter()
    with open(paths["sig"], "w") as f:
        f.write("\n".join(signature_lines(exported)) + "\n")
    save_exported(paths["ep"], exported)
    paths["seconds"] = {"export": t1 - t0, "compile": t2 - t1, "save": time.perf_counter() - t2}
    return paths


class ArtifactRunner:
    """Serve images through a saved program, with no model code.

    The consumer side of the export, as JAX's ``ArtifactRunner``: inputs of
    any ``h ≤ H, w ≤ W`` are reflect-padded bottom and right up to the
    program's static size (edge-padded where the pad exceeds the image)
    and the outputs cropped back; groups are filled up to a fixed export
    batch by cycling real images (the engine's batch-BN-safe slot filling),
    while batch-polymorphic programs run each group exactly. The input
    contract is the program's input dtype: uint8 programs take [0, 255]
    bytes, float ones [0, 1] fp32."""

    def __init__(self, artifact: Union[str, torch.export.ExportedProgram]):
        self.exported = load_exported(artifact) if isinstance(artifact, str) else artifact
        inputs = user_inputs(self.exported)
        if len(inputs) != 1:
            raise ValueError("ArtifactRunner serves baked programs (signature f(x)); this one takes "
                             f"{len(inputs)} inputs: re-export with bake_params=True")
        b, h, w, _ = inputs[0].shape
        self.batch: Optional[int] = b if isinstance(b, int) else None
        self.height, self.width = int(h), int(w)
        self.input = "uint8" if inputs[0].dtype == torch.uint8 else "float32"
        self.device = inputs[0].device
        self._fn = self.exported.module()

    @staticmethod
    def _pad_hw(img: np.ndarray, h: int, w: int) -> np.ndarray:
        ph, pw = h - img.shape[0], w - img.shape[1]
        if ph or pw:
            mode = "reflect" if ph < img.shape[0] and pw < img.shape[1] else "edge"
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode=mode)
        return img

    def _ingest(self, img) -> np.ndarray:
        """uint8 means [0, 255], float means [0, 1]; only float → uint8
        quantises (round, ≤ 1/510)."""
        a = np.asarray(img)
        if a.dtype == np.uint8:
            return a if self.input == "uint8" else a.astype(np.float32) / 255.0
        if self.input == "uint8":
            return np.clip(np.round(np.asarray(a, np.float32) * 255.0), 0.0, 255.0).astype(np.uint8)
        return np.asarray(a, np.float32)

    def __call__(self, images: Sequence[np.ndarray], group: int = 8) -> List[np.ndarray]:
        """Dehaze HWC images (float [0, 1] or uint8 [0, 255]); returns HWC
        arrays at each input's size in the program's output dtype. ``group``
        caps a polymorphic program's batch; a fixed-batch program always
        runs its export batch."""
        h, w = self.height, self.width
        for im in images:
            if im.ndim != 3 or im.shape[2] != 3:
                raise ValueError(f"expected an HWC RGB image, got shape {im.shape}")
            if im.shape[0] > h or im.shape[1] > w:
                raise ValueError(f"image {im.shape[:2]} exceeds the program's static {h}x{w}: "
                                 "re-export larger or tile upstream")
        step = self.batch or max(1, group)
        outs: List[np.ndarray] = []
        for i in range(0, len(images), step):
            chunk = list(images[i:i + step])
            padded = [self._pad_hw(self._ingest(im), h, w) for im in chunk]
            if self.batch is not None:
                while len(padded) < self.batch:
                    padded.append(padded[len(padded) % len(chunk)])
            with torch.inference_mode():
                y = self._fn(torch.from_numpy(np.stack(padded)).to(self.device)).cpu().numpy()
            outs.extend(y[j, :im.shape[0], :im.shape[1]].copy() for j, im in enumerate(chunk))
        return outs
