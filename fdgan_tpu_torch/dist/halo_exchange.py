"""Halo exchange over a spatially sharded image axis, and the spatial context.

Counterpart of ``fdgan_tpu/dist/halo_exchange.py``. JAX shards H (or W) over
a mesh axis and exchanges boundary rows with ``jax.lax.ppermute`` inside a
``shard_map``; GSPMD inserts the same exchanges when it partitions a jitted
forward. Torch has no partitioner: each rank is a process that holds one
block of rows, and every exchange is written out here. A rank sends rows to
the previous and the next rank of its spatial group and receives theirs; the
ends of the ring receive nothing and keep zeros, as ``ppermute`` gives, which
is a conv's zero padding.

- :func:`halo_sizes` (as JAX's): the leading and trailing rows a shard needs
  for a conv of kernel k, padding p and stride s.
- :func:`exchange_halo`: a shard extended by its neighbours' rows, an
  ``autograd.Function`` whose backward sends each halo's cotangent back to
  the rank that owns those rows, where it is added.
- :func:`halo_rows`: the rows before and after a shard, apart from it, for
  K1 (one row), K3's blur (7, reflected at the image's ends by K3 itself)
  and Laplacian, and SSIM's window; differentiable as :func:`exchange_halo`.
- :func:`conv2d_halo_sharded`: a conv over NCHW x with H or W sharded: the
  halo covers the sharded dim, the other is padded locally; each shard
  keeps only the rows of the global output it owns.
- :func:`global_mean`: a loss term's mean over the whole image, as each
  rank's share of it.
- :func:`spatial_sharding`: the context in which the models and the losses
  run sharded. Inside it ``nn.layers.Conv2d`` takes its halo here, the dense
  blocks give K1 their neighbours' rows (``ops/dense.py``), K3 and SSIM take
  theirs, and every batch statistic is combined over the mesh
  (``dist/stats.global_batch_stats``). Outside it nothing changes.

The transport is point-to-point, ``dist.batch_isend_irecv`` to the two
neighbours (the analogue of ``ppermute``): each rank sends and receives one
message each way per exchange, whatever the number of shards. Peers are
global ranks. NCCL takes CUDA tensors; gloo's point-to-point ops read a
tensor's memory from the host, so with gloo a CUDA tensor goes through host
memory (the several gloo ranks that share one card; ``counts["host_staged"]``
counts those exchanges).

``counts`` holds the exchanges this process made (``exchanges``: one per
call with a neighbour, forward or backward), the bytes it sent, the
exchanges staged through the host, and the all-reduces of
:func:`global_mean`'s counts (``counts``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fdgan_tpu_torch.dist.stats import global_batch_stats

counts = {"exchanges": 0, "bytes": 0, "host_staged": 0, "counts": 0}

_TAG_DOWN, _TAG_UP = 1, 2  # a message to the next rank, to the previous one


def reset_counts() -> None:
    counts.update(exchanges=0, bytes=0, host_staged=0, counts=0)


def halo_sizes(kernel: int, padding: int, stride: int) -> Tuple[int, int]:
    """(leading, trailing) halo rows a shard needs along the sharded dim."""
    lead = padding
    trail = max(kernel - padding - stride, 0)
    return lead, trail


@dataclasses.dataclass(frozen=True)
class SpatialShard:
    """A rank's place in its spatial group: the group, the global ranks of
    its members in order along the sharded axis, and this rank's index."""

    group: "dist.ProcessGroup"
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def prev(self) -> Optional[int]:
        """The global rank that holds the rows before this rank's, or None."""
        return self.ranks[self.index - 1] if self.index > 0 else None

    @property
    def next(self) -> Optional[int]:
        """The global rank that holds the rows after this rank's, or None."""
        return self.ranks[self.index + 1] if self.index + 1 < self.size else None


def shard_of(group: "dist.ProcessGroup") -> SpatialShard:
    """This rank's :class:`SpatialShard` in ``group`` (a group's rank order
    is the order of its rows)."""
    return SpatialShard(group, tuple(dist.get_process_group_ranks(group)), dist.get_rank(group))


_shard: Optional[SpatialShard] = None  # the spatial group of the sharded forward in progress


@contextlib.contextmanager
def spatial_sharding(group: Optional["dist.ProcessGroup"], stats_group: Optional["dist.ProcessGroup"]):
    """Run a model with its H axis sharded over ``group`` (this rank's
    spatial group; None or one rank: H is whole here) and its batch
    statistics taken over ``stats_group`` (the whole mesh). Inside the
    block ``nn.layers.Conv2d`` exchanges its halo over ``group``, the dense
    blocks give K1 their neighbours' rows, the fusion discriminator gives
    K3 its 7 rows a side and SSIM takes 5, ``avg_pool`` checks that a
    window stays on this rank, :func:`global_mean` makes each loss term
    this rank's share, and ``dist.stats.combine`` takes every statistic over
    ``stats_group`` with this rank's count."""
    global _shard
    prev = _shard
    shard = shard_of(group) if group is not None else None
    _shard = shard if shard is not None and shard.size > 1 else None
    try:
        with global_batch_stats(stats_group):
            yield
    finally:
        _shard = prev


def current() -> Optional[SpatialShard]:
    """The spatial shard of the sharded forward in progress, or None (no
    context, or a spatial group of one rank)."""
    return _shard


def _swap(shard: SpatialShard, to_prev, to_next, from_prev, from_next) -> None:
    """Send ``to_prev`` to the previous rank and ``to_next`` to the next,
    and receive into ``from_prev`` (from the previous) and ``from_next``
    (from the next); each a tensor or None, a receive buffer any tensor that
    is written in place. A message whose peer does not exist is skipped
    (its buffer keeps what it holds). One exchange in ``counts``."""
    sends = [(t, peer, tag) for t, peer, tag in ((to_prev, shard.prev, _TAG_UP), (to_next, shard.next, _TAG_DOWN))
             if t is not None and peer is not None]
    recvs = [(t, peer, tag) for t, peer, tag in ((from_prev, shard.prev, _TAG_DOWN), (from_next, shard.next, _TAG_UP))
             if t is not None and peer is not None]
    if not sends and not recvs:
        return
    device = (sends or recvs)[0][0].device
    staged = device.type != "cpu" and dist.get_backend(shard.group) == "gloo"
    home = torch.device("cpu") if staged else device
    ops, landed = [], []
    for t, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, t.detach().to(home).contiguous(), peer, shard.group, tag))
        counts["bytes"] += t.numel() * t.element_size()
    for t, peer, tag in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype, device=home)
        ops.append(dist.P2POp(dist.irecv, buf, peer, shard.group, tag))
        landed.append((t, buf))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for t, buf in landed:
        t.copy_(buf)
    counts["exchanges"] += 1
    counts["host_staged"] += int(staged)


def _rows_out(x: torch.Tensor, lead: int, trail: int, shard: SpatialShard, dim: int):
    """The forward exchange: (head, tail), the previous rank's last ``lead``
    rows of x along ``dim`` and the next rank's first ``trail`` rows, zeros
    at the ends of the ring."""
    n = x.shape[dim]
    if n < max(lead, trail):
        raise ValueError(f"a shard of {n} rows along dim {dim} is smaller than its halo ({lead}, {trail})")
    head = torch.zeros_like(x.narrow(dim, 0, lead))   # the previous rank's last rows, zeros at the ring's end
    tail = torch.zeros_like(x.narrow(dim, 0, trail))  # the next rank's first rows
    _swap(shard, x.narrow(dim, 0, trail) if trail else None, x.narrow(dim, n - lead, lead) if lead else None,
          head if lead else None, tail if trail else None)
    return head, tail


def _rows_back(dx: torch.Tensor, ct_head: torch.Tensor, ct_tail: torch.Tensor, lead: int, trail: int,
               shard: SpatialShard, dim: int) -> torch.Tensor:
    """The backward exchange: each halo's cotangent goes back to the rank
    that owns its rows, and the ones that come back are added, in place, to
    ``dx``'s last ``lead`` rows (the next rank's head) and first ``trail``
    rows (the previous rank's tail). Returns ``dx``."""
    n = dx.shape[dim]
    from_next = torch.zeros_like(dx.narrow(dim, 0, lead))   # the next rank's ct_head: my last lead rows'
    from_prev = torch.zeros_like(dx.narrow(dim, 0, trail))  # the previous rank's ct_tail: my first trail rows'
    _swap(shard, ct_head if lead else None, ct_tail if trail else None, from_prev if trail else None,
          from_next if lead else None)
    if lead:
        dx.narrow(dim, n - lead, lead).add_(from_next)
    if trail:
        dx.narrow(dim, 0, trail).add_(from_prev)
    return dx


class _ExchangeHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lead: int, trail: int, shard: SpatialShard, dim: int):
        ctx.meta = (lead, trail, shard, dim, x.shape[dim])
        head, tail = _rows_out(x, lead, trail, shard, dim)
        out = torch.cat([head, x, tail], dim)
        if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    @staticmethod
    def backward(ctx, ct):
        lead, trail, shard, dim, n = ctx.meta
        ct_head, ct_x, ct_tail = ct.split([lead, n, trail], dim)
        return _rows_back(ct_x.clone(), ct_head, ct_tail, lead, trail, shard, dim), None, None, None, None


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lead: int, trail: int, shard: SpatialShard, dim: int):
        ctx.meta = (lead, trail, shard, dim, x.shape)
        return _rows_out(x, lead, trail, shard, dim)

    @staticmethod
    def backward(ctx, ct_head, ct_tail):
        lead, trail, shard, dim, shape = ctx.meta
        dx = ct_head.new_zeros(shape)
        return _rows_back(dx, ct_head, ct_tail, lead, trail, shard, dim), None, None, None, None


def halo_rows(x: torch.Tensor, lead: int, trail: int, dim: int = 1,
              shard: Optional[SpatialShard] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top, bottom): the ``lead`` rows of x's image just before this rank's
    shard along ``dim`` (the previous rank's last rows) and the ``trail``
    rows just after it (the next rank's first), zeros at an end of the image,
    in the spatial group of ``shard`` (default: :func:`current`'s). Apart,
    not concatenated to x: K1, K3 and their twins take them so
    (differentiable: the backward sends each row's cotangent back to its
    owner, which adds it to its first or last rows)."""
    shard = shard if shard is not None else current()
    if shard is None:
        raise RuntimeError("halo_rows runs inside spatial_sharding, over a spatial group of more than one rank")
    return _HaloRows.apply(x, lead, trail, shard, dim)


def exchange_halo(x: torch.Tensor, lead: int, trail: int, group: "dist.ProcessGroup", dim: int) -> torch.Tensor:
    """x, this rank's shard along ``dim``, extended by ``lead`` rows from the
    previous rank of ``group`` in front and ``trail`` rows from the next
    behind; zeros at the ends of the ring (differentiable: the backward adds
    each halo's cotangent to the owner's rows). A channels_last x gives a
    channels_last result."""
    return _ExchangeHalo.apply(x, lead, trail, shard_of(group), dim)


def _pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def conv2d_halo_sharded(weight: torch.Tensor, bias: Optional[torch.Tensor], x: torch.Tensor,
                        group: Optional["dist.ProcessGroup"], padding: Union[int, Sequence[int]] = 1,
                        stride: Union[int, Sequence[int]] = 1, dim: str = "H") -> torch.Tensor:
    """A conv (OIHW ``weight``, NCHW x) with H (``dim='H'``) or W sharded over
    ``group``, in x's dtype: the sharded dim takes its halo from the
    neighbours (:func:`halo_sizes`), the other is zero-padded locally.
    ``padding`` and ``stride`` are ints or (H, W) pairs. Requirements, as
    JAX's: kernel ≥ padding along the sharded dim, and the local extent a
    multiple of the stride and no smaller than the halo. A group of one rank
    (or None) is the plain conv.

    Each shard yields only the rows of the global output that it owns. A
    shard of h rows yields h/s of them, which is the global count unless the
    conv's trailing halo reaches past the global padding: a 4×4 conv with
    stride 1 and padding 1 (``halo_sizes`` (1, 2)) gives H − 1 rows globally,
    and the last shard's last row would read a second zero row that the
    global padding does not have. The last shard drops such rows
    (:func:`trailing_excess`), so the next conv's halo and a BN's statistics
    see the global extent. JAX never meets this: GSPMD partitions the
    unsharded conv."""
    if dim not in ("H", "W"):
        raise ValueError(f"dim must be 'H' or 'W', got {dim!r}")
    d = 2 if dim == "H" else 3
    (ph, pw), (sh, sw) = _pair(padding), _pair(stride)
    p, s = (ph, sh) if dim == "H" else (pw, sw)
    k = weight.shape[d]
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    shard = shard_of(group) if group is not None else None
    if shard is None or shard.size == 1:
        return F.conv2d(x, w, b, stride=(sh, sw), padding=(ph, pw))
    if k < p:
        raise ValueError(f"kernel {k} below padding {p} along the sharded dim")
    if x.shape[d] % s:
        raise ValueError(f"the local extent {x.shape[d]} along the sharded dim does not divide by the stride {s}")
    lead, trail = halo_sizes(k, p, s)
    xe = _ExchangeHalo.apply(x, lead, trail, shard, d)
    y = F.conv2d(xe, w, b, stride=(sh, sw), padding=(0, pw) if dim == "H" else (ph, 0))
    drop = trailing_excess(k, p, s)
    if not drop:
        return y
    # every rank narrows (the last by `drop` rows), so that every rank's autograd graph has the same nodes
    keep = y.shape[d] - (drop if shard.next is None else 0)
    return y.narrow(d, 0, keep).contiguous(memory_format=torch.channels_last)


def trailing_excess(kernel: int, padding: int, stride: int) -> int:
    """The rows that a sharded conv's last shard yields past the global
    output (:func:`conv2d_halo_sharded`): with a global extent n that divides
    by the stride the shards yield n/s rows together, the conv
    ⌊(n + 2p − k)/s⌋ + 1; 1 for a 4×4 conv of stride 1 and padding 1."""
    return max(0, -((2 * padding - kernel) // stride + 1))


def spatial_size() -> int:
    """The ranks of the spatial group of the sharded forward in progress (1
    outside one)."""
    return _shard.size if _shard is not None else 1


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of a loss term over the whole image. Outside a sharded
    forward it is ``t.mean()``. Inside :func:`spatial_sharding` (over a
    spatial group of more than one rank) it is this rank's share: the sum
    over its band divided by the spatial group's count of elements, which
    one all-reduce of the count gives (``counts["counts"]``), so that the
    shares of a spatial group add up to the image's mean. The gradients of
    the shares, summed over the spatial group, are the mean's
    (``dist.mesh.average_gradients``)."""
    shard = _shard
    if shard is None:
        return t.mean()
    n = torch.full((), float(t.numel()), dtype=torch.float64, device=t.device)
    dist.all_reduce(n, op=dist.ReduceOp.SUM, group=shard.group)
    counts["counts"] += 1
    return t.sum() / n.to(t.dtype)


def exchange_rows(src: torch.Tensor, top: torch.Tensor, bottom: torch.Tensor, shard: SpatialShard) -> None:
    """One exchange of NHWC ``src``'s boundary rows, for K1's halo: its first
    row to the previous rank and its last to the next, and the previous
    rank's last row into ``top``, the next rank's first into ``bottom``
    ((B, 1, W, C) tensors, written in place, channel slices of the dense
    block's halo rows; not written at the ends of the ring). No autograd."""
    _swap(shard, src[:, :1], src[:, -1:], top, bottom)
