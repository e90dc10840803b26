"""Sequential PyTorch oracle for the selective (input-dependent) SSM scan.

Counterpart of ``aum_tpu/ops/scan_ref.py::selective_scan_ref``, in the same
(batch, length, channel) layout. Recurrence per batch b, channel d, state n,
all math in fp32:

    dt_t  = softplus(delta_t + delta_bias)            (if delta_softplus)
    x_t   = exp(dt_t * A[d,n]) * x_{t-1} + dt_t * B_t[n] * u_t
    y_t   = sum_n C_t[n] * x_t[n]  (+ D[d] * u_t)
    out_t = y_t * silu(z_t)                           (if z given)

``reverse=True`` runs the recurrence right to left, which equals
flip -> scan -> flip without materialising flipped copies. ``initial_state``
starts the recurrence from a carried (B, D, N) state instead of zeros, and
``return_last_state`` also returns the (B, D, N) fp32 state after the last
processed step (position 0 when reversed). ``save_every=k`` also returns the
state at the entry of every chunk of k processed steps, the chunk-entry
states the scan kernel saves for its backward.
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
    initial_state: torch.Tensor | None = None,
    return_last_state: bool = False,
):
    """u, delta, z: (B, L, D); A: (D, N); B, C: (B, L, N); D, delta_bias: (D,);
    initial_state: (B, D, N) or None (zeros).

    Returns out (B, L, D) in u's dtype; with ``save_every`` > 0 or
    ``return_last_state`` a tuple: out, then xb (B, ceil(L / save_every), N,
    D) fp32, the state before processed step c * save_every (the starting
    state for c = 0; counted right to left if reverse), then the last state
    (B, D, N) fp32, each where asked for.
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
    x = (u.new_zeros((bsz, d, A.shape[1])) if initial_state is None
         else initial_state.float())
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
    out = (y.to(in_dtype),)
    if save_every:
        out += (torch.stack(states, dim=1),)
    if return_last_state:
        out += (x,)
    return out if len(out) > 1 else out[0]
