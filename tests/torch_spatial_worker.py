"""Worker process for tests/test_torch_train_spatial.py; not a test module.

Each invocation is one rank of a gloo process group over localhost, joined
through ``FDGAN_TPU_DIST`` and its coordinates (``dist.mesh.run_local_ranks``
starts the ranks), on a 1 x world ``("data", "spatial")`` mesh: every rank
holds the same images, each a band of their rows (``dist.mesh.spatial_rows``,
uneven where they do not divide). It runs, on its band:

- :data:`TAIL`: two 4x4 stride-1 padding-1 convs, the fusion discriminator's
  tail (``conv2d_halo_sharded``, whose last shard drops the row past the
  global output at each), and the gradient of sum(y · ct) through them;
- :data:`SSIM`: ``ops.ssim.ssim`` (this rank's share of the mean) and its
  gradient with respect to the first image;
- with ``--step`` (the input file's batch and G and D): one fp32 train step
  of ``make_train_step(mesh=)`` with ``remat="stages"``, as JAX's
  ``tests/test_dist.py::test_train_step_sp_grad_parity`` runs its sharded
  step; the same step with the halo rows' backward sends dropped, the
  negative control; D's output rows on this band.

Everything goes to ``<out_dir>/rank<r>.pt``, beside the exchanges and the
collectives counted.

Usage: python torch_spatial_worker.py <in.pt> <out_dir> [--step]
"""

import contextlib
import os
import sys

import numpy as np
import torch

# (name, shape NHWC, channels out): the discriminator's two 4x4 stride-1 tail convs over H = 40
TAIL = ((2, 40, 12, 5), 4)
SSIM = (2, 40, 24, 3)


def tail_inputs():
    """x (NHWC), the two OIHW weights and biases, and the cotangent of the
    second conv's output (H − 2 rows), float32, from a seed of their own."""
    rng = np.random.default_rng(7)
    shape, cout = TAIL
    cin = shape[-1]
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    w1 = rng.uniform(-0.25, 0.25, (cout, cin, 4, 4)).astype(np.float32)
    b1 = rng.uniform(-0.25, 0.25, (cout,)).astype(np.float32)
    w2 = rng.uniform(-0.25, 0.25, (cout, cout, 4, 4)).astype(np.float32)
    b2 = rng.uniform(-0.25, 0.25, (cout,)).astype(np.float32)
    ct = rng.standard_normal((shape[0], shape[1] - 2, shape[2] - 2, cout)).astype(np.float32)
    return x, w1, b1, w2, b2, ct


def ssim_inputs():
    """Two NHWC images in [0, 1], the second near the first."""
    rng = np.random.default_rng(8)
    a = rng.uniform(size=SSIM).astype(np.float32)
    return a, np.clip(a + 0.1 * rng.standard_normal(SSIM), 0, 1).astype(np.float32)


def tail_conv(x, w1, b1, w2, b2, group=None):
    """The two tail convs over NCHW x (H sharded over ``group``, else whole)."""
    from fdgan_tpu_torch.dist.halo_exchange import conv2d_halo_sharded

    h = conv2d_halo_sharded(w1, b1, x, group, padding=1)
    return conv2d_halo_sharded(w2, b2, h, group, padding=1)


def _collectives() -> dict:
    from fdgan_tpu_torch.dist import halo_exchange, mesh
    from fdgan_tpu_torch.dist import stats as dist_stats

    return {"exchanges": halo_exchange.counts["exchanges"], "counts": halo_exchange.counts["counts"],
            "stats_forward": dist_stats.collectives["forward"], "stats_backward": dist_stats.collectives["backward"],
            "grads": mesh.counts["grads"], "metrics": mesh.counts["metrics"]}


def _reset() -> None:
    from fdgan_tpu_torch.dist import halo_exchange, mesh
    from fdgan_tpu_torch.dist import stats as dist_stats

    halo_exchange.reset_counts()
    dist_stats.reset_counts()
    mesh.reset_counts()


@contextlib.contextmanager
def dropped_halo_cotangents():
    """The negative control: every halo exchange's backward keeps its own
    rows' cotangent and neither sends nor adds the halo rows'."""
    from fdgan_tpu_torch.dist import halo_exchange

    orig = halo_exchange._rows_back
    halo_exchange._rows_back = lambda dx, *args: dx
    try:
        yield
    finally:
        halo_exchange._rows_back = orig


def run_step(blob, m, control=False) -> dict:
    """One fp32 step with H sharded over ``m`` from ``blob``'s state: the
    metrics, the gradients handed to Adam (G's and D's, by parameter name)
    and the collectives."""
    from fdgan_tpu_torch.dist import mesh
    from fdgan_tpu_torch.losses.composite import LossWeights
    from fdgan_tpu_torch.train.loop import create_train_state, make_train_step

    state, tx_g, tx_d = create_train_state(0, device="cpu")
    state.g.load_state_dict(blob["g"], strict=True)
    state.d.load_state_dict(blob["d"], strict=True)
    grads = {"g": {}, "d": {}}
    for net in ("g", "d"):
        names = {p: n for n, p in getattr(state, net).named_parameters()}

        def keep(opt, args, kwargs, into=grads[net], names=names):
            into.update({names[p]: p.grad.clone() for group in opt.param_groups for p in group["params"]
                         if p.grad is not None})

        getattr(state, f"{net}_opt").register_step_pre_hook(keep)
    step = make_train_step(tx_g, tx_d, LossWeights(perceptual=0.0), remat="stages", mesh=m)
    haze, gt = mesh.shard_batch((blob["haze"], blob["gt"]), m, spatial=True)
    _reset()
    with dropped_halo_cotangents() if control else contextlib.nullcontext():
        _, metrics = step(state, haze, gt)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads, "collectives": _collectives()}


def main():
    inp, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    from fdgan_tpu_torch.dist import halo_exchange, mesh
    from fdgan_tpu_torch.models.discriminators import fusion_apply
    from fdgan_tpu_torch.ops.ssim import ssim

    mesh.maybe_init_distributed("cpu")
    world, rank = mesh.world_size(), mesh.rank()
    assert world > 1, "FDGAN_TPU_DIST and its coordinates must be set"
    m = mesh.make_mesh(1, world, device_type="cpu")
    group = m.get_group("spatial")
    out = {"rank": rank, "world": world}

    x, w1, b1, w2, b2, ct = (torch.from_numpy(a) for a in tail_inputs())
    r0, r1 = mesh.spatial_rows(x.shape[1], world)[rank]
    xl = x[:, r0:r1].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    ws = [t.clone().requires_grad_(True) for t in (w1, b1, w2, b2)]
    _reset()
    y = tail_conv(xl, *ws, group=group)
    forward_exchanges = halo_exchange.counts["exchanges"]
    ct_rows = ct[:, r0:r0 + y.shape[2]].permute(0, 3, 1, 2)  # this rank's rows of the global output
    (y * ct_rows).sum().backward()
    out["tail"] = {"y": y.detach().permute(0, 2, 3, 1).contiguous(), "dx": xl.grad.permute(0, 2, 3, 1).contiguous(),
                   "dw": [t.grad for t in ws], "forward_exchanges": forward_exchanges,
                   "exchanges": halo_exchange.counts["exchanges"]}

    a, b = (torch.from_numpy(t) for t in ssim_inputs())
    r0, r1 = mesh.spatial_rows(a.shape[1], world)[rank]
    al = a[:, r0:r1].clone().requires_grad_(True)
    _reset()
    with halo_exchange.spatial_sharding(group, None):
        share = ssim(al, b[:, r0:r1])
    share.backward()
    out["ssim"] = {"share": share.detach(), "da": al.grad, "collectives": _collectives()}

    if "--step" in sys.argv[3:]:
        blob = torch.load(inp, weights_only=True)
        out["step"] = run_step(blob, m)
        out["control"] = run_step(blob, m, control=True)
        from fdgan_tpu_torch.models.discriminators import NLayerDiscriminator

        d = NLayerDiscriminator(input_nc=9, device="cpu")
        d.load_state_dict(blob["d"], strict=True)
        gt = mesh.shard_batch((blob["gt"],), m, spatial=True)[0]
        with torch.no_grad(), halo_exchange.spatial_sharding(group, torch.distributed.group.WORLD):
            out["d_rows"] = int(fusion_apply(d, gt).shape[1])
        if rank:  # the tests read rank 0's gradients only: after the reduction every rank holds them
            for run in ("step", "control"):
                del out[run]["grads"]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
