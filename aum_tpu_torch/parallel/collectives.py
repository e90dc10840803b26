"""The collectives of the parallel modes, explicit, with the bytes each moves.

JAX inserts its collectives through GSPMD; the port runs one process per rank
and calls ``torch.distributed`` here, and nowhere else. ``torch.distributed``
is the transport: NCCL when every rank has a card of its own, gloo on the
CPU, and gloo when ranks share one card (the caller names it; see
``parallel/multihost.py``).

Under gloo a CUDA tensor goes through host memory: every collective here
copies it into a pinned host buffer, runs gloo on that, and copies the
result back to the card. gloo has no CUDA ``send``/``recv`` at all, so the
pipeline's handoff always stages that way under gloo; its all-reduce,
all-gather and broadcast are staged here too, so that every collective takes
the same path. Under NCCL the tensors stay on the card.

``BYTES`` counts, per tag, the bytes each call moves on this rank: the
tensor handed in for an all-reduce, a broadcast, a send or a recv, and the
gathered result for an all-gather. A group of one rank moves nothing and
is skipped, except under NCCL, where the call is made (so that a one-rank
NCCL group runs this code) and counted. Callers tag by purpose (``tp_x_dbl``,
``dp_grads``, ``pp_send``, ...); ``reset_counts`` zeroes them.

The autograd functions below are the collectives' differentiable forms:
``copy_to_group`` (identity forward, all-reduce backward),
``reduce_from_group`` (all-reduce forward, identity backward),
``reduce_both`` (all-reduce forward and backward), ``gather_segments`` (an
all-gather along a dim forward, this rank's segment backward)
and ``slice_segment`` (this rank's segment forward, an all-gather of the
segments' grads backward).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

BYTES: collections.Counter = collections.Counter()


def reset_counts() -> None:
    BYTES.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(group, t: torch.Tensor) -> bool:
    """True when ``t`` must go through host memory: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _moves_nothing(group) -> bool:
    """No group, or one rank: nothing to move (under NCCL the call is still
    made, so that a one-rank NCCL group runs the collectives' code)."""
    return group is None or (size(group) == 1 and dist.get_backend(group) != dist.Backend.NCCL)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce(t: torch.Tensor, group, tag: str = "all_reduce") -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if _moves_nothing(group):
        return t
    BYTES[tag] += _nbytes(t)
    if _staged(group, t):
        host = _to_host(t)
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0, tag: str = "all_gather") -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along ``dim``, in rank order."""
    if _moves_nothing(group):
        return t
    n = size(group)
    src = t.contiguous()
    BYTES[tag] += n * _nbytes(src)
    if _staged(group, src):
        host = _to_host(src)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(t.device)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int, group, tag: str = "broadcast") -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group``, in place."""
    if _moves_nothing(group):
        return t
    BYTES[tag] += _nbytes(t)
    if _staged(group, t):
        host = _to_host(t)
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


class Pending:
    """A send or recv in flight: ``wait()`` finishes it (and for a recv
    staged through the host, copies the data into the target tensor)."""

    def __init__(self, work, host=None, target=None):
        self._work, self._host, self._target = work, host, target

    def wait(self) -> None:
        self._work.wait()
        if self._target is not None:
            self._target.copy_(self._host)


def send(t: torch.Tensor, dst: int, group, tag: str = "send") -> Pending:
    """Start sending ``t`` to global rank ``dst``; under gloo a CUDA tensor is
    first copied to a pinned host buffer, kept alive until ``wait``."""
    BYTES[tag] += _nbytes(t)
    if _staged(group, t):
        host = _to_host(t)
        return Pending(dist.isend(host, dst, group=group), host)
    return Pending(dist.isend(t.contiguous(), dst, group=group))


def recv(t: torch.Tensor, src: int, group, tag: str = "recv") -> Pending:
    """Start receiving into ``t`` from global rank ``src`` (see ``send``)."""
    BYTES[tag] += _nbytes(t)
    if _staged(group, t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return Pending(dist.irecv(host, src, group=group), host, t)
    return Pending(dist.irecv(t, src, group=group))


def gather_rows(x: torch.Tensor, group, tag: str = "gather_rows") -> torch.Tensor:
    """The rows of every rank's ``x`` (sizes may differ by rank), put back in
    the order that ``order[r::n]`` slicing took them from: rank r's row j
    becomes row j * n + r. On one rank, ``x``."""
    n = size(group)
    if n == 1:
        return x
    counts = all_gather(torch.tensor([x.shape[0]], device=x.device), group, tag=tag)
    longest = int(counts.max())
    padded = torch.zeros((longest,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    padded[:x.shape[0]] = x
    parts = all_gather(padded, group, tag=tag).split(longest)
    out = torch.empty((int(counts.sum()),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    for r, part in enumerate(parts):
        out[r::n] = part[:int(counts[r])]
    return out


# --- differentiable forms ---------------------------------------------------------


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group, ctx.tag + "_bwd"), None, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        return all_reduce(x.contiguous().clone(), group, tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        return all_reduce(x.contiguous().clone(), group, tag)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group, ctx.tag + "_bwd"), None, None


class _GatherSegments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tag):
        ctx.group, ctx.dim, ctx.seg = group, dim, x.shape[dim]
        return all_gather(x, group, dim, tag)

    @staticmethod
    def backward(ctx, g):
        r = rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.seg, ctx.seg), None, None, None


class _SliceSegment(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tag):
        n = size(group)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {n} ranks")
        ctx.group, ctx.dim, ctx.tag = group, dim, tag
        seg = x.shape[dim] // n
        return x.narrow(dim, rank(group) * seg, seg)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim, ctx.tag + "_bwd"), None, None, None


def copy_to_group(x, group, tag: str = "copy_to_group"):
    """Identity forward; the grads of the group's ranks summed backward: for
    a tensor every rank holds whole that feeds per-rank work."""
    return x if group is None else _CopyToGroup.apply(x, group, tag)


def reduce_from_group(x, group, tag: str = "reduce_from_group"):
    """The sum of the ranks' partial ``x`` forward; identity backward: for
    partial sums whose consumers every rank repeats identically."""
    return x if group is None else _ReduceFromGroup.apply(x, group, tag)


def reduce_both(x, group, tag: str = "reduce_both"):
    """The sum of the ranks' partial ``x`` forward, and of the grads
    backward: for partial sums whose consumers are per-rank."""
    return x if group is None else _ReduceBoth.apply(x, group, tag)


def gather_segments(x, group, dim: int, tag: str = "gather_segments"):
    """The ranks' segments concatenated along ``dim`` forward; backward, each
    rank takes the grad of its own segment (every rank repeats the consumers
    identically, so the grad of the whole is already complete)."""
    return x if group is None else _GatherSegments.apply(x, group, dim, tag)


def slice_segment(x, group, dim: int, tag: str = "slice_segment"):
    """This rank's equal segment of ``x`` along ``dim`` forward; backward the
    segments' grads gathered, so every rank holds the grad of the whole."""
    return x if group is None else _SliceSegment.apply(x, group, dim, tag)
