"""Sequence-parallel selective scan over a process group.

Counterpart of ``aum_tpu/ops/seq_parallel.py``. The scan is a linear
recurrence x_t = a_t x_{t-1} + b_t, so a sequence split in length over S
ranks scans in two passes with one small exchange:

1. each rank scans its segment from zero with ``return_final_state`` (the
   segment's end state s) and forms the segment's decay product
   p = exp(sum(dt) · A), a (B, D, N) summary;
2. the ranks all-gather (p, s) (flipped for a reverse scan, which takes the
   segments right to left), and each combines the segments before its own,
   (p1, s1) then (p2, s2) -> (p1 p2, p2 s1 + s2), into its true start state;
3. each rank scans its segment again from that state (``initial_state``).

Both passes are ``ops.selective_scan``: on CUDA tensors its single-direction
forward kernel with a carried state and, in the backward, K2's with_state
form (the final state's grad in, the initial state's grad out).

The collectives and their backward rules (``parallel/collectives.py``):

- ``seq_parallel_scan`` takes this rank's segment of each (B, L, ·) operand.
  Its summary all-gather and combine (``_CarryExchange``) feed per-rank
  work (each rank's own start state), so the backward sums the ranks'
  grads of each summary, an all-reduce that every rank reaches (rank 0's
  start state is the initial one, yet its backward still joins). The grads
  it gives A, D, delta_bias and ``initial_state`` are this rank's part: the
  caller sums them over the group (``copy_to_group``); the final state is
  held whole by every rank and its grad is taken once (rank 0's).
- ``sharded_scan`` keeps ``sharded_scan_in_jit``'s contract: it takes the
  global (B, L, ·) operands, which every rank of the group holds whole,
  pads L to a multiple of S with dt -> 0 steps (delta = -1e4 before the
  softplus: decay 1, no input, exact in both directions), scans this rank's
  segment and all-gathers the outputs. The output gather feeds work every
  rank repeats identically, so its backward hands each rank the grad of its
  own segment, not the sum over ranks (S times too large); the segment cut
  of each operand gathers the segments' grads in its backward, and A, D and
  the dt bias sum theirs, so every rank ends with the whole gradient of
  every operand and the parameters before the scan need no reduction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aum_tpu_torch.ops.selective_scan import selective_scan
from aum_tpu_torch.parallel import collectives

PAD_DELTA = -1e4


def _segment_summary(delta, A, delta_bias, delta_softplus):
    """(B, D, N) decay product over the segment, exp(sum(dt) · A), in fp32."""
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()[None, None, :]
    if delta_softplus:
        dt = F.softplus(dt)
    return torch.exp(dt.sum(dim=1)[:, :, None] * A.float()[None])


class _CarryExchange(torch.autograd.Function):
    """(p, s, x0) of this rank -> (its start state, the final state): the
    summaries all-gathered in scan order and combined. Backward: this rank's
    grads of every segment's (p, s) through the combine, summed over the
    ranks (one all-reduce), of which it keeps its own."""

    @staticmethod
    def forward(ctx, p, s, x0, group, reverse):
        n, r = collectives.size(group), collectives.rank(group)
        ps = collectives.all_gather(p.unsqueeze(0), group, tag="sp_summary")
        ss = collectives.all_gather(s.unsqueeze(0), group, tag="sp_summary")
        if reverse:
            ps, ss = ps.flip(0), ss.flip(0)
        starts = [x0]
        for i in range(n):
            starts.append(ps[i] * starts[i] + ss[i])
        ctx.save_for_backward(ps, *starts)
        ctx.group, ctx.reverse, ctx.order = group, reverse, (n - 1 - r if reverse else r)
        return starts[ctx.order], starts[n]

    @staticmethod
    def backward(ctx, g_start, g_fin):
        ps, *starts = ctx.saved_tensors
        n, r = collectives.size(ctx.group), collectives.rank(ctx.group)
        g = [torch.zeros_like(starts[0]) for _ in starts]
        g[ctx.order] = g[ctx.order] + g_start
        if r == 0:  # every rank holds the final state whole: count its grad once
            g[n] = g[n] + g_fin
        g_ps, g_ss = torch.empty_like(ps), torch.empty_like(ps)
        for i in reversed(range(n)):
            g_ps[i] = g[i + 1] * starts[i]
            g_ss[i] = g[i + 1]
            g[i] = g[i] + g[i + 1] * ps[i]
        both = torch.stack([g_ps, g_ss])
        if ctx.reverse:
            both = both.flip(1)
        both = collectives.all_reduce(both.contiguous(), ctx.group, tag="sp_summary_bwd")
        return both[0, r], both[1, r], g[0], None, None


def seq_parallel_scan(u, delta, A, B, C, D, z, delta_bias=None, delta_softplus: bool = True,
                      reverse: bool = False, group=None, initial_state=None,
                      return_final_state: bool = False):
    """Selective scan whose length is split over ``group``: each (B, L, ·)
    operand is this rank's contiguous segment, in rank order; A, D,
    delta_bias and ``initial_state`` (which starts the whole scan) are
    whole on every rank, and their grads this rank's part. Returns this
    rank's segment of y and, with ``return_final_state``, the whole scan's
    final state (the same on every rank)."""
    _, s_loc = selective_scan(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                              reverse=reverse, return_final_state=True)
    p_loc = _segment_summary(delta, A, delta_bias, delta_softplus)
    x0 = torch.zeros_like(s_loc) if initial_state is None else initial_state.float()
    x_start, x_fin = _CarryExchange.apply(p_loc, s_loc, x0, group, reverse)
    out = selective_scan(u, delta, A, B, C, D, z, delta_bias, delta_softplus, reverse=reverse,
                         initial_state=x_start)
    return (out, x_fin) if return_final_state else out


def sharded_scan(u, delta, A, B, C, D, z, delta_bias, *, group, delta_softplus: bool = True,
                 reverse: bool = False):
    """``seq_parallel_scan`` on the global (B, L, ·) operands, which every
    rank of ``group`` holds whole: L padded to a multiple of the group's
    size, this rank's segment scanned, the outputs all-gathered and the
    padding cut. Returns the global y."""
    n = collectives.size(group)
    length = u.shape[1]
    pad = (-length) % n
    if pad:
        u, B, C, z = (F.pad(t, (0, 0, 0, pad)) for t in (u, B, C, z))
        delta = F.pad(delta, (0, 0, 0, pad), value=PAD_DELTA if delta_softplus else 0.0)
    seg = [collectives.slice_segment(t, group, 1, tag="sp_operands")
           for t in (u, delta, B, C, z)]
    rep = [None if t is None else collectives.copy_to_group(t, group, tag="sp_params")
           for t in (A, D, delta_bias)]
    y = seq_parallel_scan(seg[0], seg[1], rep[0], seg[2], seg[3], rep[1], seg[4], rep[2],
                          delta_softplus, reverse=reverse, group=group)
    y = collectives.gather_segments(y, group, 1, tag="sp_output")
    return y[:, :length] if pad else y
