"""Sequential PyTorch oracle for the selective (input-dependent) SSM scan.

Counterpart of ``aum_tpu/ops/scan_ref.py::selective_scan_ref``, in the same
(batch, length, channel) layout. Recurrence per batch b, channel d, state n,
all math in fp32:

    dt_t  = softplus(delta_t + delta_bias)            (if delta_softplus)
    x_t   = exp(dt_t * A[d,n]) * x_{t-1} + dt_t * B_t[n] * u_t
    y_t   = sum_n C_t[n] * x_t[n]  (+ D[d] * u_t)
    out_t = y_t * silu(z_t)                           (if z given)

``reverse=True`` runs the recurrence right to left, which equals
flip -> scan -> flip without materialising flipped copies.
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
) -> torch.Tensor:
    """u, delta, z: (B, L, D); A: (D, N); B, C: (B, L, N); D, delta_bias: (D,).

    Returns (B, L, D) in u's dtype.
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
    steps = range(seqlen - 1, -1, -1) if reverse else range(seqlen)
    for t in steps:
        da = torch.exp(delta[:, t, :, None] * A[None])
        dbu = (delta[:, t] * u[:, t])[:, :, None] * Bv[:, t, None, :]
        x = da * x + dbu
        ys[t] = torch.einsum("bdn,bn->bd", x, Cv[:, t])
    y = torch.stack(ys, dim=1)

    if D is not None:
        y = y + u * D.float()[None, None, :]
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(in_dtype)
