"""Single-token selective-state update (one decode step of the SSM).

Counterpart of ``aum_tpu/ops/state_update.py``, the reference's Triton
``selective_state_update`` (and its oracle), which ``Mamba.step`` runs for
autoregressive decoding. It is plain PyTorch on every device, as the JAX
package leaves it to XLA outside any Pallas kernel: one token is a few
(B, D, N) elementwise passes, below a kernel's worth of work. The state is
fp32 throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def selective_state_update(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                           D: torch.Tensor | None = None, z: torch.Tensor | None = None,
                           dt_bias: torch.Tensor | None = None,
                           dt_softplus: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the selective SSM.

    state: (B, D, N) fp32; x: (B, D) conv output for this token; dt: (B, D)
    timestep (pre-softplus if ``dt_softplus``); A: (D, N); B, C: (B, N); D:
    (D,); z: (B, D); dt_bias: (D,). Returns (y (B, D) in x's dtype, the new
    (B, D, N) fp32 state).
    """
    xf = x.float()
    dt = dt.float()
    if dt_bias is not None:
        dt = dt + dt_bias.float()[None, :]
    if dt_softplus:
        dt = F.softplus(dt)
    dA = torch.exp(dt[:, :, None] * A.float()[None])
    dB = dt[:, :, None] * B.float()[:, None, :]
    new_state = state.float() * dA + xf[:, :, None] * dB
    y = torch.einsum("bdn,bn->bd", new_state, C.float())
    if D is not None:
        y = y + D.float()[None, :] * xf
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(x.dtype), new_state
