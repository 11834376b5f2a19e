"""Worker process for the 2-rank CPU tests of the port's data-parallel step
(tests/test_torch_train.py); not a test module.

Each invocation is one rank of a gloo process group over localhost, joined
through ``FDGAN_TPU_DIST`` and its coordinates in the environment, as
``cli/train`` joins one (``dist.mesh.run_local_ranks`` starts the ranks). It
runs three fp32 steps of the port's data-parallel ``make_train_step`` on its
rows of the global batch, each from the same state
(``fdgan_tpu_torch.tools.dp_step.run_step``): with the batch statistics
global across the ranks, the same under ``remat=True``, and, as the
negative control, with per-rank statistics (``local_stats=True``, as
torch's DDP without SyncBatchNorm would have it). The results go to
``<out_dir>/rank<r>.pt`` for the parent test to hold against JAX.

Usage: python torch_dist_worker.py <in.pt> <out_dir>
"""

import os
import sys

import torch


def main():
    inp, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    from fdgan_tpu_torch.dist import mesh
    from fdgan_tpu_torch.tools import dp_step

    mesh.maybe_init_distributed("cpu")
    assert mesh.world_size() > 1, "FDGAN_TPU_DIST and its coordinates must be set"
    blob = torch.load(inp, weights_only=True)
    runs = {"global": dp_step.run_step(blob, "cpu"), "remat": dp_step.run_step(blob, "cpu", remat=True),
            "local": dp_step.run_step(blob, "cpu", local_stats=True)}
    if mesh.rank() != 0:  # the tests read rank 0's gradients only
        for run in runs.values():
            del run["grads"]
    torch.save({"rank": mesh.rank(), "world": mesh.world_size(), "runs": runs},
               os.path.join(out_dir, f"rank{mesh.rank()}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
