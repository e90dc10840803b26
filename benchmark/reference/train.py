"""Plain reference of the train step: mean BCE on the logits, its gradient,
and Adam with L2 weight decay (the gradient plus ``weight_decay`` times the
parameter, before the moments; ``torch.optim.Adam``'s rule, written out).

``train_steps`` starts from the benchmark's weights and takes one step per
batch. It returns each step's loss, the per-leaf norm of the first
gradient as Adam takes it (weight decay included), the per-leaf norm of the
raw gradient at the first step (which decides which leaves count) and the
per-leaf norm of the parameters' change after the last step.
``half_batch`` takes the mean over the first half of each batch only, the
fault a check has to catch. Imports only torch and this package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import aum


def adam_update(p, g, m, v, step: int, lr: float, betas, eps: float) -> None:
    b1, b2 = betas
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    denom = (v.sqrt() / (1 - b2 ** step) ** 0.5).add_(eps)
    p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))


def train_steps(params: dict, model: dict, batches, *, lr: float, betas, eps: float,
                weight_decay: float, rnd=lambda t: t.float(), half_batch: bool = False) -> dict:
    """``batches``: a list of (x, y). Returns {"losses", "grad1", "raw_grad1",
    "change"}, the last three as {key: norm}."""
    p = {k: v.detach().float().clone().requires_grad_(True) for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": []}
    for step, (x, y) in enumerate(batches, start=1):
        if half_batch:
            x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
        loss = F.binary_cross_entropy_with_logits(
            aum.logits(p, model, x, rnd, checkpoint_blocks=True), y.float())
        grads = torch.autograd.grad(loss, list(p.values()))
        out["losses"].append(loss.item())
        with torch.no_grad():
            if step == 1:
                out["raw_grad1"] = {k: float(g.norm()) for k, g in zip(p, grads)}
            for (k, t), g in zip(p.items(), grads):
                g = g + weight_decay * t
                if step == 1:
                    out.setdefault("grad1", {})[k] = float(g.norm())
                adam_update(t, g, m[k], v2[k], step, lr, betas, eps)
        del grads, loss
    with torch.no_grad():
        out["change"] = {k: float((p[k] - start[k]).norm()) for k in p}
    return out
