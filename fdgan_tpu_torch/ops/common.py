"""What the kernel wrappers of ``fdgan_tpu_torch.ops`` share.

``pixel_stride`` reads the layout the kernels take: an NHWC tensor, or a
channel slice of a wider NHWC buffer. ``twin_vjp`` is the backward of K1,
K2 and K3: the VJP of a kernel's plain twin, recomputed from the inputs
that a ``torch.autograd.Function`` or a ``torch.library`` op's autograd
(``ops/library.py``) saved (``channel_stats`` has its VJP in closed form
instead, ``ops/stats.py``).
"""

from __future__ import annotations

import torch


def pixel_stride(t: torch.Tensor, name: str = "x") -> int:
    """The elements from one pixel of the NHWC tensor ``t`` to the next: C
    where t is NHWC-contiguous, more where t is a channel slice of a wider
    NHWC-contiguous buffer (strides (H·W·ld, W·ld, ld, 1), ld ≥ C). The
    kernels address pixel p at p·ld; any other layout raises."""
    if t.dim() != 4:
        raise ValueError(f"{name} must be NHWC (B, H, W, C), got shape {tuple(t.shape)}")
    b, h, w, c = t.shape
    s = t.stride()
    ld = s[2] if w > 1 else s[1] if h > 1 else s[0] if b > 1 else c
    # the batch is compared last: under export it may be symbolic, and a comparison on it would guard it
    if not ((c == 1 or s[3] == 1) and (h == 1 or s[1] == w * ld) and (s[0] == h * w * ld or b == 1)):
        raise ValueError(f"{name} must be NHWC-contiguous or a channel slice of an NHWC-contiguous buffer, "
                         f"got strides {s} for shape {tuple(t.shape)}")
    if ld < c:
        raise ValueError(f"{name} has a pixel stride ld={ld} below its C={c} channels")
    n = t.numel()
    if isinstance(n, int) and n and (n // c - 1) * ld + c >= 2**31:  # symbolic under export: the op checks
        raise ValueError(f"{name} is too large for the kernels' 32-bit pixel indices")
    return ld


def twin_vjp(twin, ctx, cts):
    """The VJP of ``twin`` at the saved inputs of a Function or an op's
    autograd context (None where an optional input was None), for the
    inputs that need a grad: the backward of K1, K2 and K3."""
    need = ctx.needs_input_grad
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        outs = twin(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
        wanted = [t for t, n in zip(inputs, need) if n]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [c for _, c in pairs], allow_unused=True))
    return tuple(next(grads) if n else None for n in need)
