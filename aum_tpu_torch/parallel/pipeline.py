"""GPipe pipeline parallelism over the block stack.

Counterpart of ``aum_tpu/parallel/pipeline.py``. The depth of the block
stack is split over the 'pipe' group: stage s holds depth/P contiguous
layers. The batch is cut into m microbatches, m the largest divisor of B
that is at most ``microbatches`` (JAX's rule, so a tail batch still runs;
m = 1 is plain sequential). Forward: stage 0 feeds each microbatch in turn,
every stage runs its layers on what it receives and hands the result to the
next stage; the last stage's results, concatenated, are broadcast to every
stage (JAX's masked psum), so every stage runs the head and the loss on the
same values. Backward (GPipe's: all microbatches forward, then all
backward): each stage keeps its microbatches' inputs and outputs, receives
the output grads from the next stage (the last stage takes them from the
head), runs ``torch.autograd.backward`` through its layers, which
accumulates its layers' parameter grads, and sends the input grads to the
previous stage; stage 0's input grads are broadcast back, so the layers
before the stack (patch embed, cls and pos embed), which every stage holds
and runs, get the whole gradient on every stage, and so do the final norm
and the head. No parameter grad then needs a reduction over 'pipe'.

The handoffs are point-to-point sends (``parallel/collectives.py``), through
a pinned host buffer under gloo, which has no CUDA send or recv. Stages
wait for each other as the schedule's bubbles require: P - 1 of the m + P - 1
ticks of each pass are idle on each stage.

``block_stage_fn`` runs a stage's layers on one microbatch;
``block_stage_fn_dp`` also applies each layer's drop-path mask, taken from
masks drawn once for the whole batch before the pipeline (the model draws
them from its explicit generator, in module scope) and cut to the
microbatch, so they travel with their samples.
"""

from __future__ import annotations

import torch

from aum_tpu_torch.parallel import collectives


def microbatch_count(batch: int, microbatches: int) -> int:
    """The largest divisor of ``batch`` that is at most ``microbatches``."""
    return max(v for v in range(1, min(microbatches, batch) + 1) if batch % v == 0)


class _Schedule:
    """One pipelined call: the stage function, the group, and what the
    forward keeps for the backward."""

    def __init__(self, stage_fn, group, ranks, m: int):
        self.stage_fn, self.group, self.ranks, self.m = stage_fn, group, ranks, m
        self.stage = ranks.index(torch.distributed.get_rank()) if group is not None else 0
        self.n = len(ranks)
        self.saved = []

    def forward(self, carry: tuple, keep: bool) -> tuple:
        s, n, m = self.stage, self.n, self.m
        chunks = [c.chunk(m) for c in carry]
        outs, pending = [], []
        for i in range(m):
            if s == 0:
                x = tuple(c[i] for c in chunks)
            else:
                x = tuple(torch.empty_like(c[i]) for c in chunks)
                for p in [collectives.recv(t, self.ranks[s - 1], self.group, tag="pp_recv")
                          for t in x]:
                    p.wait()
            if keep:
                x = tuple(t.detach().requires_grad_(t.is_floating_point()) for t in x)
                with torch.enable_grad():
                    y = tuple(self.stage_fn(x, i))
                self.saved.append((x, y))
            else:
                y = tuple(self.stage_fn(x, i))
            if s < n - 1:
                pending += [collectives.send(t.detach(), self.ranks[s + 1], self.group,
                                             tag="pp_send") for t in y]
            else:
                outs.append(tuple(t.detach() for t in y))
        for p in pending:
            p.wait()
        result = tuple(torch.cat([o[j] for o in outs]) if s == n - 1 else torch.empty_like(c)
                       for j, c in enumerate(carry))
        for t in result:
            collectives.broadcast(t, self.ranks[-1], self.group, tag="pp_out")
        return result

    def backward(self, grads: tuple) -> tuple:
        s, n, m = self.stage, self.n, self.m
        g_chunks = [g.contiguous().chunk(m) for g in grads]
        firsts, pending = [None] * m, []
        for i in reversed(range(m)):
            x, y = self.saved[i]
            if s == n - 1:
                g = tuple(gc[i] for gc in g_chunks)
            else:
                g = tuple(torch.empty_like(t) for t in y)
                for p in [collectives.recv(t, self.ranks[s + 1], self.group, tag="pp_recv")
                          for t in g]:
                    p.wait()
            pairs = [(t, gt) for t, gt in zip(y, g) if t.requires_grad]
            torch.autograd.backward([t for t, _ in pairs], [gt for _, gt in pairs])
            gx = tuple(t.grad if t.grad is not None else torch.zeros_like(t) for t in x)
            if s > 0:
                pending += [collectives.send(t, self.ranks[s - 1], self.group, tag="pp_send")
                            for t in gx]
            else:
                firsts[i] = gx
        for p in pending:
            p.wait()
        self.saved = []
        result = tuple(torch.cat([f[j] for f in firsts]) if s == 0 else torch.empty_like(g)
                       for j, g in enumerate(grads))
        for t in result:
            collectives.broadcast(t, self.ranks[0], self.group, tag="pp_in_grad")
        return result


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, schedule, anchor, *carry):
        ctx.schedule = schedule
        return schedule.forward(carry, keep=True)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + ctx.schedule.backward(grads)


def pipeline_apply(stage_fn, carry: tuple, group, ranks, microbatches: int = 4) -> tuple:
    """Run ``carry`` (a tuple of (B, ...) tensors, every stage's the same)
    through the stages of ``group`` (global ``ranks``, in stage order).

    ``stage_fn(x, i)`` applies this stage's layers to microbatch ``i``'s
    ``x`` (a tuple shaped like ``carry``'s chunks) and returns the same
    structure. Returns the stack's output on every stage. Differentiable:
    under grad mode the backward runs the GPipe backward described above.
    """
    batch = carry[0].shape[0]
    schedule = _Schedule(stage_fn, group, tuple(ranks), microbatch_count(batch, microbatches))
    if not torch.is_grad_enabled():
        return schedule.forward(carry, keep=False)
    # The anchor makes autograd call the backward even when no carry tensor
    # needs a grad: the stage's own layers still do.
    anchor = torch.zeros((), device=carry[0].device, requires_grad=True)
    return _Pipeline.apply(schedule, anchor, *carry)


def block_stage_fn(units, run_unit):
    """Stage function over this stage's ``units`` (layers, or layer pairs):
    ``run_unit(unit, hidden, residual, None)`` per unit, in order."""

    def f(x, i):
        hidden, residual = x
        for unit in units:
            hidden, residual = run_unit(unit, hidden, residual, None)
        return hidden, residual

    return f


def block_stage_fn_dp(units, run_unit, masks, m: int):
    """``block_stage_fn`` with drop path: ``masks[k]`` is unit k's (mask,
    keep) over the whole batch (a pair's: two of them), drawn once before
    the pipeline; microbatch ``i`` takes its rows of each mask."""

    def rows(drop, i):
        if drop is None:
            return None
        mask, keep = drop
        return mask.chunk(m)[i], keep

    def f(x, i):
        hidden, residual = x
        for unit, drop in zip(units, masks):
            cut = ([rows(d, i) for d in drop] if isinstance(drop, list) else rows(drop, i))
            hidden, residual = run_unit(unit, hidden, residual, cut)
        return hidden, residual

    return f
