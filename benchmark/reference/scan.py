"""Plain fp32 selective scan, written from the Mamba paper's recurrence.

    dt_t  = softplus(delta_t + delta_bias)
    h_t   = exp(dt_t * A) * h_{t-1} + dt_t * u_t * B_t       (per channel d, state n)
    y_t   = sum_n C_t[n] h_t[n] + D * u_t
    out_t = y_t * silu(z_t)

``reverse`` runs right to left. The recurrence h_t = a_t h_{t-1} + b_t is a
``torch.autograd.Function`` with a hand-written adjoint, g_t = dH_t +
a_{t+1} g_{t+1}, da_t = g_t h_{t-1}, db_t = g_t, so the backward costs one
loop over time as the forward does; everything around it is ordinary
autograd over whole tensors. Imports only torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class LinearRecurrence(torch.autograd.Function):
    """H[t] = a[t] * H[t-1] + b[t] along dim 0 (t = 0 first, or last when
    ``reverse``), from a zero state."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor, reverse: bool):
        out = torch.empty_like(b)
        h = torch.zeros_like(b[0])
        steps = range(b.shape[0] - 1, -1, -1) if reverse else range(b.shape[0])
        for t in steps:
            torch.addcmul(b[t], a[t], h, out=out[t])
            h = out[t]
        ctx.save_for_backward(a, out)
        ctx.reverse = reverse
        return out

    @staticmethod
    def backward(ctx, d_out: torch.Tensor):
        a, out = ctx.saved_tensors
        n = a.shape[0]
        g_all = torch.empty_like(d_out)
        g = torch.zeros_like(d_out[0])
        # The adjoint runs against the forward's order; a_next multiplies the
        # carry from the step the forward took after t.
        steps = range(n) if ctx.reverse else range(n - 1, -1, -1)
        prev = None
        for t in steps:
            if prev is None:
                g_all[t].copy_(d_out[t])
            else:
                torch.addcmul(d_out[t], a[prev], g, out=g_all[t])
            g = g_all[t]
            prev = t
        h_before = torch.zeros_like(out)
        if ctx.reverse:
            h_before[:-1] = out[1:]
        else:
            h_before[1:] = out[:-1]
        return g_all * h_before, g_all, None


def selective_scan(u, delta, A, B, C, D, z, delta_bias, reverse: bool = False):
    """u, delta, z: (Bt, L, Dm); A: (Dm, N); B, C: (Bt, L, N); D, delta_bias:
    (Dm,). Returns out (Bt, L, Dm) fp32."""
    u, delta, z, B, C = (t.float() for t in (u, delta, z, B, C))
    dt = F.softplus(delta + delta_bias.float())
    # Time first, so that each step of the recurrence reads contiguous rows.
    dt_t, u_t = dt.transpose(0, 1), u.transpose(0, 1)          # (L, Bt, Dm)
    a = torch.exp(dt_t[..., None] * A.float())                   # (L, Bt, Dm, N)
    b = (dt_t * u_t)[..., None] * B.transpose(0, 1)[:, :, None, :]
    h = LinearRecurrence.apply(a, b, reverse)
    y = torch.einsum("lbdn,lbn->lbd", h, C.transpose(0, 1)).transpose(0, 1)
    y = y + u * D.float()
    return y * F.silu(z)
