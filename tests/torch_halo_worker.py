"""Worker process for tests/test_torch_halo_exchange.py; not a test module.

Each invocation is one rank of a gloo process group over localhost, joined
through ``FDGAN_TPU_DIST`` and its coordinates (``dist.mesh.run_local_ranks``
starts the ranks); all ranks form one spatial group. For each case of
:data:`CASES` the rank takes its block of the case's input along the
sharded dim, runs the port's ``conv2d_halo_sharded`` on it, and
differentiates sum(y · ct) with the case's cotangent: its output block, the
gradient of its block of x, and its share of the weight's and bias's
gradients go to ``<out_dir>/rank<r>.pt``, beside the exchanges counted.

Usage: python torch_halo_worker.py <out_dir>
"""

import os
import sys

import numpy as np
import torch

# (name, x shape NHWC, (in, out, kernel), padding, stride, dim, relu after): tests/test_halo_exchange.py's cases
CASES = [
    ("3x3", (2, 64, 32, 6), (6, 8, 3), 1, 1, "H", False),
    ("5x5", (1, 32, 16, 3), (3, 4, 5), 2, 1, "H", False),
    ("3x3_s2", (1, 64, 16, 4), (4, 8, 3), 1, 2, "H", False),
    ("4x4_s2", (1, 64, 16, 3), (3, 8, 4), 1, 2, "H", False),
    ("w_axis", (1, 16, 64, 3), (3, 4, 3), 1, 1, "W", False),
    ("encoder_stage", (1, 64, 32, 3), (3, 64, 3), 1, 1, "H", True),  # conv_refin1, then relu
]


def case_inputs(name):
    """The case's input x (NHWC), HWIO kernel, bias and the output cotangent
    (NHWC, float32 numpy), from a seed of its own."""
    i = [c[0] for c in CASES].index(name)
    _, shape, (cin, cout, k), pad, stride, dim, _ = CASES[i]
    rng = np.random.default_rng(100 + i)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    bound = 1 / np.sqrt(cin * k * k)
    kernel = rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)
    bias = rng.uniform(-bound, bound, (cout,)).astype(np.float32)
    h, w = shape[1], shape[2]
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    ct = rng.standard_normal((shape[0], oh, ow, cout)).astype(np.float32)
    return x, kernel, bias, ct


def main():
    out_dir = sys.argv[1]
    torch.set_num_threads(1)
    from fdgan_tpu_torch.dist import halo_exchange, mesh

    mesh.maybe_init_distributed("cpu")
    world, rank = mesh.world_size(), mesh.rank()
    assert world > 1, "FDGAN_TPU_DIST and its coordinates must be set"
    group = torch.distributed.group.WORLD
    results = {}
    for name, _, _, pad, stride, dim, relu in CASES:
        x, kernel, bias, ct = (torch.from_numpy(a) for a in case_inputs(name))
        d = 1 if dim == "H" else 2  # the sharded dim of NHWC
        n, no = x.shape[d] // world, ct.shape[d] // world
        xl = x.narrow(d, rank * n, n).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        xl.requires_grad_(True)
        w = kernel.permute(3, 2, 0, 1).contiguous().requires_grad_(True)
        b = bias.clone().requires_grad_(True)
        halo_exchange.reset_counts()
        y = halo_exchange.conv2d_halo_sharded(w, b, xl, group, padding=pad, stride=stride, dim=dim)
        if relu:
            y = torch.relu(y)
        forward_exchanges = halo_exchange.counts["exchanges"]
        ctl = ct.narrow(d, rank * no, no).permute(0, 3, 1, 2)
        (y * ctl).sum().backward()
        results[name] = {"y": y.detach().permute(0, 2, 3, 1).contiguous(), "dx": xl.grad.permute(0, 2, 3, 1).contiguous(),
                         "dw": w.grad, "db": b.grad, "forward_exchanges": forward_exchanges,
                         "exchanges": halo_exchange.counts["exchanges"],
                         "channels_last": y.is_contiguous(memory_format=torch.channels_last)}
    torch.save({"rank": rank, "world": world, "cases": results}, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
