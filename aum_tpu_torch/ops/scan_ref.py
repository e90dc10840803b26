"""Sequential PyTorch oracle for the selective (input-dependent) SSM scan.

Counterpart of ``aum_tpu/ops/scan_ref.py::selective_scan_ref``, in the same
(batch, length, channel) layout. Recurrence per batch b, channel d, state n,
all math in fp32:

    dt_t  = softplus(delta_t + delta_bias)            (if delta_softplus)
    x_t   = exp(dt_t * A[d,n]) * x_{t-1} + dt_t * B_t[n] * u_t
    y_t   = sum_n C_t[n] * x_t[n]  (+ D[d] * u_t)
    out_t = y_t * silu(z_t)                           (if z given)

``reverse=True`` runs the recurrence right to left, which equals
flip -> scan -> flip without materialising flipped copies. ``save_every=k``
also returns the state at the entry of every chunk of k processed steps, the
chunk-entry states the scan kernel saves for its backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def selective_scan_ref(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor | None = None,
    z: torch.Tensor | None = None,
    delta_bias: torch.Tensor | None = None,
    delta_softplus: bool = False,
    reverse: bool = False,
    save_every: int = 0,
):
    """u, delta, z: (B, L, D); A: (D, N); B, C: (B, L, N); D, delta_bias: (D,).

    Returns (B, L, D) in u's dtype; with ``save_every`` > 0, (out, xb) where
    xb (B, ceil(L / save_every), N, D) fp32 holds the state before processed
    step c * save_every (zero for c = 0; counted right to left if reverse).
    """
    in_dtype = u.dtype
    u = u.float()
    delta = delta.float()
    Bv = B.float()
    Cv = C.float()
    A = A.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, None, :]
    if delta_softplus:
        delta = F.softplus(delta)

    bsz, seqlen, d = u.shape
    x = u.new_zeros((bsz, d, A.shape[1]))
    ys = [None] * seqlen
    states = []
    steps = range(seqlen - 1, -1, -1) if reverse else range(seqlen)
    for i, t in enumerate(steps):
        if save_every and i % save_every == 0:
            states.append(x.transpose(1, 2))
        da = torch.exp(delta[:, t, :, None] * A[None])
        dbu = (delta[:, t] * u[:, t])[:, :, None] * Bv[:, t, None, :]
        x = da * x + dbu
        ys[t] = torch.einsum("bdn,bn->bd", x, Cv[:, t])
    y = torch.stack(ys, dim=1)

    if D is not None:
        y = y + u * D.float()[None, None, :]
    if z is not None:
        y = y * F.silu(z.float())
    if save_every:
        return y.to(in_dtype), torch.stack(states, dim=1)
    return y.to(in_dtype)
