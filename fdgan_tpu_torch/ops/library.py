"""The ``fdgan::`` operators: K1, K2 and ``channel_stats`` as PyTorch ops.

The hand-written kernels are bound once, through ``ctypes``
(``ops/build.py``); these ``torch.library`` operators are the form in
which the rest of PyTorch sees them. ``torch.export`` traces through them
(their fake implementations give the output shapes), AOTInductor calls
them from a compiled package, and a libtorch process without Python finds
the same schemas in ``native/fdgan_ops.cpp``. Importing this module
registers the ops and pulls in no model code: a saved ``ExportedProgram``
loads with it alone (``io/export.py``).

The kernel ops take what the kernels' C entry points take:

- ``dense_layer`` (K1): x (B, H, W, C), possibly a channel slice of a wider
  NHWC buffer of pixel stride ``ld``; the folded norm1 (a1, b1) and norm2
  (a2, b2) affines; W1 and W2 in the layout of the implementation that x's
  device runs (the kernels' planes on CUDA: ``ops/dense.py::_k1_operands``;
  the twin's (C, 128) and HWIO (3, 3, 128, 32) on the CPU); the halo rows'
  pixel offsets ``top`` and ``bot`` from x (-1 for none); and ``out``, the
  (B, H, W, 32) tensor of pixel stride ``ldo`` it writes. It writes in
  place, as the kernel does, so that a dense block's concat stays one
  buffer in an exported program too.
- ``h_stats`` (K2): norm2's batch mean and biased variance, two fp32 (128,)
  tensors; the per-block partials are reduced in float64 inside the op.
- ``channel_stats``: per-channel fp32 (mean, biased var) of bf16 x.

The ops are tagged so that Inductor hands them the strides they were
traced with; the CUDA implementations compare ``ld``/``ldo`` with the
tensors' own strides and raise on a layout they were not given. On a CPU
tensor each runs its plain twin (``ops/dense.py``, ``ops/stats.py``).

Autograd: ``channel_stats`` carries its closed-form VJP. K1's and K2's
kernel ops take the kernels' weight layouts, and the fp32 kernels' layout
(a TF32 split) has no derivative: their autograd boundary is at the plain
weights, the ops ``fused_dense_layer`` and ``h_batch_stats`` (the twins'
VJPs), which run the kernel ops inside and appear in no exported graph.
"""

from __future__ import annotations

import torch

# the kernel ops; native/fdgan_ops.cpp defines the same schemas, letter for letter
SCHEMAS = {
    "dense_layer": "dense_layer(Tensor x, Tensor a1, Tensor b1, Tensor w1, Tensor a2, Tensor b2, Tensor w2, "
                   "int ld, int top, int bot, Tensor(a!) out, int ldo) -> ()",
    "h_stats": "h_stats(Tensor x, Tensor a1, Tensor b1, Tensor w1, int ld) -> (Tensor, Tensor)",
    "channel_stats": "channel_stats(Tensor x, int ld) -> (Tensor, Tensor)",
}
# the autograd boundary of K1 and K2, over plain weights (Python only)
GRAD_SCHEMAS = {
    "fused_dense_layer": "fused_dense_layer(Tensor x, Tensor a1, Tensor b1, Tensor w1, Tensor a2, Tensor b2, "
                         "Tensor w2) -> Tensor",
    "h_batch_stats": "h_batch_stats(Tensor x, Tensor a1, Tensor b1, Tensor w1) -> (Tensor, Tensor)",
}
INTER, GROWTH = 128, 32
# Inductor keeps the strides a tagged op was traced with; older torch knows only the stride order
STRIDE_TAG = getattr(torch.Tag, "needs_exact_strides", torch.Tag.needs_fixed_stride_order)

_lib = torch.library.Library("fdgan", "DEF")  # held for the process: the ops live as long as it does
for _name, _schema in {**SCHEMAS, **GRAD_SCHEMAS}.items():
    _lib.define(_schema, tags=(STRIDE_TAG,) if _name in SCHEMAS else ())


# --- implementations (imported at the call: this module stays light) ---------

def _dense_layer_cpu(x, a1, b1, w1, a2, b2, w2, ld, top, bot, out, ldo):
    from fdgan_tpu_torch.ops import dense

    dense.twin_into(x, a1, b1, w1, a2, b2, w2, ld, top, bot, out, ldo)


def _dense_layer_cuda(x, a1, b1, w1, a2, b2, w2, ld, top, bot, out, ldo):
    from fdgan_tpu_torch.ops import dense

    dense._launch_k1(x, a1, b1, w1, a2, b2, w2, ld, top, bot, out, ldo)


def _h_stats_cpu(x, a1, b1, w1, ld):
    from fdgan_tpu_torch.ops import dense

    dense.check_stride(x, ld, "x")
    return dense.h_stats_reference(x, a1, b1, w1)


def _h_stats_cuda(x, a1, b1, w1, ld):
    from fdgan_tpu_torch.ops import dense

    return dense._launch_k2(x, a1, b1, w1, ld)


def _channel_stats_cpu(x, ld):
    from fdgan_tpu_torch.ops import dense, stats

    dense.check_stride(x, ld, "x")
    return stats.one_pass_reference(x)


def _channel_stats_cuda(x, ld):
    from fdgan_tpu_torch.ops import stats

    return stats._launch(x, ld)


def _fused_dense_layer(x, a1, b1, w1, a2, b2, w2):
    from fdgan_tpu_torch.ops import dense

    return dense.k1(x, a1, b1, w1, a2, b2, w2)


def _h_batch_stats(x, a1, b1, w1):
    from fdgan_tpu_torch.ops import dense

    return dense.k2(x, a1, b1, w1)


for _name, _cpu, _cuda in (("dense_layer", _dense_layer_cpu, _dense_layer_cuda),
                           ("h_stats", _h_stats_cpu, _h_stats_cuda),
                           ("channel_stats", _channel_stats_cpu, _channel_stats_cuda),
                           ("fused_dense_layer", _fused_dense_layer, _fused_dense_layer),
                           ("h_batch_stats", _h_batch_stats, _h_batch_stats)):
    _lib.impl(_name, _cpu, "CPU")
    _lib.impl(_name, _cuda, "CUDA")


# --- fake implementations: the shapes, for export and the compilers -------------

@torch.library.register_fake("fdgan::dense_layer", lib=_lib)
def _(x, a1, b1, w1, a2, b2, w2, ld, top, bot, out, ldo):
    return None


def _stats_fake(n):
    return lambda x, *rest: (x.new_empty(n(x), dtype=torch.float32), x.new_empty(n(x), dtype=torch.float32))


torch.library.register_fake("fdgan::h_stats", _stats_fake(lambda x: INTER), lib=_lib)
torch.library.register_fake("fdgan::h_batch_stats", _stats_fake(lambda x: INTER), lib=_lib)
torch.library.register_fake("fdgan::channel_stats", _stats_fake(lambda x: x.shape[-1]), lib=_lib)


@torch.library.register_fake("fdgan::fused_dense_layer", lib=_lib)
def _(x, a1, b1, w1, a2, b2, w2):
    return x.new_empty(tuple(x.shape[:3]) + (GROWTH,))


# --- autograd --------------------------------------------------------------------

def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _save_channel_stats(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], *output)


def _fused_dense_layer_backward(ctx, ct):
    from fdgan_tpu_torch.ops.common import twin_vjp
    from fdgan_tpu_torch.ops.dense import layer_reference

    return twin_vjp(layer_reference, ctx, (ct,))


def _h_batch_stats_backward(ctx, ct_mean, ct_var):
    from fdgan_tpu_torch.ops.common import twin_vjp
    from fdgan_tpu_torch.ops.dense import h_stats_reference

    return twin_vjp(h_stats_reference, ctx, (ct_mean, ct_var))


def _channel_stats_backward(ctx, ct_mean, ct_var):
    from fdgan_tpu_torch.ops.stats import one_pass_vjp

    return one_pass_vjp(*ctx.saved_tensors, ct_mean, ct_var), None


torch.library.register_autograd("fdgan::fused_dense_layer", _fused_dense_layer_backward,
                                setup_context=_save_inputs, lib=_lib)
torch.library.register_autograd("fdgan::h_batch_stats", _h_batch_stats_backward, setup_context=_save_inputs,
                                lib=_lib)
torch.library.register_autograd("fdgan::channel_stats", _channel_stats_backward,
                                setup_context=_save_channel_stats, lib=_lib)
