"""Mamba mixer + residual block, eval and train forward.

Counterpart of ``aum_tpu/models/mamba.py`` with the upstream reference's
module tree and state-dict keys (``in_proj.weight`` (2*d_inner, d_model),
``conv1d.weight`` (d_inner, 1, K), ``x_proj.weight``, ``dt_proj.{weight,bias}``,
``A_log``, ``D``, ``A_b_log``, the ``*_b`` branch for v2, ``out_proj.weight``),
so a state dict exported from the JAX package loads with ``strict=True``.

Parameters are kept in fp32 and cast to the compute dtype where they are used,
as the JAX module does; ``A_log``, ``D`` and the dt bias stay fp32. The x and
z halves of the single in_proj product go to the kernels as strided column
views, and so do B and C of the x_proj product.

Variants: ``bimamba_type="v1"`` (Fo-Bi) runs the reverse scan over the same
activations with its own ``A_b``; ``"v2"`` (Bi-Bi) runs a separate branch
with an anti-causal conv, and the two outputs are summed and halved (the
reference's ``if_devide_out``, on in every configuration). ``"none"``
(Fo-Fo) needs the single-direction kernel (``_fwd_kernel_z``), which is not
ported yet. The mixer's shape and init constants (conv width 4, expand 2,
dt rank ceil(d_model / 16), dt in [1e-3, 1e-1] floored at 1e-4, conv bias)
are the reference defaults; no configuration changes them.

``MambaMixer.pre_scan`` is the pre-scan compute (in_proj, conv, x_proj,
dt_proj), the counterpart of the JAX mixer's ``pre_fn``: with
``split_remat`` it runs under ``torch.utils.checkpoint`` and is recomputed in
the backward, while the scan's saved tensors (its inputs and chunk-entry
states) stay outside the checkpoint, as the JAX ``remat_mode="split"`` does.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from aum_tpu_torch.ops import causal_conv1d, fused_add_norm, selective_scan_dual
from aum_tpu_torch.ops.conv1d import WIDTH as D_CONV  # 4: the conv kernel is built for it
EXPAND = 2
DT_MIN, DT_MAX, DT_INIT_FLOOR = 0.001, 0.1, 1e-4


class _Weights(nn.Module):
    """Parameter holder with the reference's ``weight`` / ``bias`` key names."""

    def __init__(self, weight_shape, bias_shape=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = (nn.Parameter(torch.empty(bias_shape))
                     if bias_shape is not None else None)


def _uniform_fan_in_(t: torch.Tensor, fan_in: int, generator: torch.Generator,
                     scale: float = 1.0) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(t, -bound, bound, generator=generator)
    if scale != 1.0:
        t.mul_(scale)


def _dt_bias_(t: torch.Tensor, generator: torch.Generator) -> None:
    """softplus(bias) log-uniform in [DT_MIN, DT_MAX]: store its inverse."""
    dt = torch.exp(torch.rand(t.shape, generator=generator)
                   * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
    dt = torch.clamp_min(dt, DT_INIT_FLOOR)
    t.copy_(dt + torch.log(-torch.expm1(-dt)))


def _a_log_(t: torch.Tensor) -> None:
    """S4D-real init: A_log[d, n] = log(n + 1)."""
    t.copy_(torch.log(torch.arange(1, t.shape[1] + 1, dtype=torch.float32))
            .expand_as(t))


class MambaMixer(nn.Module):
    """Selective-SSM mixer (one direction pair) for one block."""

    def __init__(self, d_model: int, d_state: int = 16, bimamba_type: str = "v2",
                 n_layer: int = 24):
        super().__init__()
        if bimamba_type == "none":
            raise NotImplementedError(
                "bimamba_type='none' (Fo-Fo) needs the single-direction scan "
                "kernel (_fwd_kernel_z), which is not ported yet")
        if bimamba_type not in ("v1", "v2"):
            raise ValueError(f"unknown bimamba_type: {bimamba_type}")
        self.d_model = d_model
        self.d_state = d_state
        self.d_inner = EXPAND * d_model
        self.dt_rank = math.ceil(d_model / 16)
        self.bimamba_type = bimamba_type
        self.n_layer = n_layer
        d_in = self.d_inner

        self.in_proj = _Weights((2 * d_in, d_model))
        self._add_branch("")
        self.A_b_log = nn.Parameter(torch.empty((d_in, d_state)))
        if bimamba_type == "v2":
            self._add_branch("_b")
        self.out_proj = _Weights((d_model, d_in))

    def _add_branch(self, suffix: str) -> None:
        d_in, rank = self.d_inner, self.dt_rank
        self.add_module(f"conv1d{suffix}", _Weights((d_in, 1, D_CONV), (d_in,)))
        self.add_module(f"x_proj{suffix}",
                        _Weights((rank + 2 * self.d_state, d_in)))
        self.add_module(f"dt_proj{suffix}", _Weights((d_in, rank), (d_in,)))
        if suffix == "":
            self.A_log = nn.Parameter(torch.empty((d_in, self.d_state)))
            self.D = nn.Parameter(torch.empty((d_in,)))
        else:
            self.D_b = nn.Parameter(torch.empty((d_in,)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d_in = self.d_inner
        _uniform_fan_in_(self.in_proj.weight, self.d_model, generator)
        suffixes = ("", "_b") if self.bimamba_type == "v2" else ("",)
        for s in suffixes:
            conv = getattr(self, f"conv1d{s}")
            _uniform_fan_in_(conv.weight, D_CONV, generator)
            _uniform_fan_in_(conv.bias, D_CONV, generator)
            _uniform_fan_in_(getattr(self, f"x_proj{s}").weight, d_in, generator)
            dt_proj = getattr(self, f"dt_proj{s}")
            _uniform_fan_in_(dt_proj.weight, self.dt_rank, generator)
            _dt_bias_(dt_proj.bias, generator)
            nn.init.ones_(getattr(self, f"D{s}"))
        _a_log_(self.A_log)
        _a_log_(self.A_b_log)
        _uniform_fan_in_(self.out_proj.weight, d_in, generator,
                         scale=1.0 / math.sqrt(self.n_layer))

    def _branch(self, xs: torch.Tensor, suffix: str, reverse_conv: bool):
        """conv -> x_proj -> dt_proj: (u, delta, B, C) for one scan direction."""
        dtype = xs.dtype
        conv = getattr(self, f"conv1d{suffix}")
        xc = causal_conv1d(xs, conv.weight[:, 0].to(dtype), conv.bias.to(dtype),
                           activation="silu", reverse=reverse_conv)
        x_dbl = xc @ getattr(self, f"x_proj{suffix}").weight.to(dtype).t()
        r, n = self.dt_rank, self.d_state
        delta = x_dbl[..., :r] @ getattr(self, f"dt_proj{suffix}").weight.to(dtype).t()
        return xc, delta, x_dbl[..., r:r + n], x_dbl[..., r + n:]

    def pre_scan(self, x: torch.Tensor):
        """In-projection, conv, x/dt projections: both directions' scan
        arguments (u, delta, A, B, C, D, z, delta_bias)."""
        dtype = x.dtype
        d_in = self.d_inner
        xz = x @ self.in_proj.weight.to(dtype).t()
        xs, z = xz[..., :d_in], xz[..., d_in:]
        u, delta, bm, cm = self._branch(xs, "", reverse_conv=False)
        a = -torch.exp(self.A_log.float())
        dt_bias = self.dt_proj.bias.float()
        args_f = (u, delta, a, bm, cm, self.D.float(), z, dt_bias)
        if self.bimamba_type == "v1":
            args_r = (u, delta, -torch.exp(self.A_b_log.float()), bm, cm,
                      args_f[5], z, dt_bias)
        else:
            u_b, delta_b, bm_b, cm_b = self._branch(xs, "_b", reverse_conv=True)
            args_r = (u_b, delta_b, -torch.exp(self.A_b_log.float()), bm_b, cm_b,
                      self.D_b.float(), z, self.dt_proj_b.bias.float())
        return args_f, args_r

    def forward(self, x: torch.Tensor, split_remat: bool = False) -> torch.Tensor:
        """x: (B, L, d_model) in the compute dtype. ``split_remat``
        checkpoints ``pre_scan`` when a grad is being taken."""
        dtype = x.dtype
        if split_remat and torch.is_grad_enabled():
            args_f, args_r = checkpoint(self.pre_scan, x, use_reentrant=False)
        else:
            args_f, args_r = self.pre_scan(x)
        y_f, y_b = selective_scan_dual(args_f, args_r)
        y = y_f + y_b  # in the compute dtype, as XLA sums it
        if self.bimamba_type == "v2":
            y = y / 2
        return y @ self.out_proj.weight.to(dtype).t()


class MambaBlock(nn.Module):
    """Add -> RMSNorm -> Mixer block with an fp32 residual stream.

    Takes (hidden, residual), returns (mixer_out, residual + hidden), the norm
    applied to the fp32 residual sum (the reference Block's contract).
    """

    def __init__(self, d_model: int, norm_epsilon: float = 1e-5,
                 bimamba_type: str = "v2", d_state: int = 16, n_layer: int = 24):
        super().__init__()
        self.norm_epsilon = norm_epsilon
        self.norm = _Weights((d_model,))
        self.mixer = MambaMixer(d_model, d_state=d_state,
                                bimamba_type=bimamba_type, n_layer=n_layer)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.norm.weight)
        self.mixer.reset_parameters(generator)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor | None,
                dtype: torch.dtype, split_remat: bool = False):
        normed, residual = fused_add_norm(
            hidden, self.norm.weight.to(dtype), residual=residual,
            prenorm=True, eps=self.norm_epsilon)
        return self.mixer(normed, split_remat=split_remat), residual
