"""Mamba mixer + residual block, eval and train forward.

Counterpart of ``aum_tpu/models/mamba.py`` with the upstream reference's
module tree and state-dict keys (``in_proj.weight`` (2*d_inner, d_model),
``conv1d.weight`` (d_inner, 1, K), ``x_proj.weight``, ``dt_proj.{weight,bias}``,
``A_log``, ``D``, ``A_b_log`` for v1/v2, the ``*_b`` branch for v2,
``out_proj.weight``), so a state dict exported from the JAX package loads with
``strict=True``.

Parameters are kept in fp32 and cast to the compute dtype where they are used,
as the JAX module does; ``A_log``, ``D`` and the dt bias stay fp32. The x and
z halves of the single in_proj product go to the kernels as strided column
views, and so do B and C of the x_proj product.

Variants: ``bimamba_type="v1"`` (Fo-Bi) runs the reverse scan over the same
activations with its own ``A_b``; ``"v2"`` (Bi-Bi) runs a separate branch
with an anti-causal conv, and the two outputs are summed and halved (the
reference's ``if_devide_out``, on in every published configuration; off,
they are only summed). ``"none"``
(Fo-Fo, and the Mamba LM's mixer) runs one forward scan
(``ops.selective_scan``, the single-direction kernel), not halved, and has
no ``A_b_log``. The mixer's shape and init constants (conv width 4, expand
2, dt rank ceil(d_model / 16), dt in [1e-3, 1e-1] floored at 1e-4, conv
bias) are the reference defaults; only an LM config changes the conv width
and the expansion (``d_conv``, ``expand``). ``d_conv`` and ``d_state`` go
to the kernels as given: the conv kernel takes any width (past 8 its
general form), the scan kernels any d_state.

Jamba's mixer (``models/jamba.py``) sets ``dt_rank`` itself and switches on
``bcdt_norms``: an RMSNorm each (``dt_layernorm``, ``b_layernorm``,
``c_layernorm``, eps ``norm_eps``) on the dt-rank columns, B and C of the
x_proj product before dt_proj and the scan, as
``transformers``' ``JambaMambaMixer`` has them; B and C are then the norms'
outputs and no longer strided views of that product. With the norms off
(every AuM mixer and the Mamba LM's) the mixer does the same work as without
the switch. ``prefill`` and ``step`` are the LM paths' per-layer work: one
parallel pass that also returns the decode caches, and one token on them.

``init_layer_scale`` adds the reference's LayerScale: a ``gamma`` (d_model,)
initialised to that value, multiplying the out_proj output. The block's
norm is RMSNorm, or with ``rms_norm=False`` a LayerNorm with a
``norm.bias``; its residual stream is fp32, or with
``residual_in_fp32=False`` in the compute dtype.

``MambaMixer.pre_scan`` is the pre-scan compute (in_proj, conv, x_proj,
dt_proj), the counterpart of the JAX mixer's ``pre_fn``: it returns the
scan arguments of each direction (Fo-Fo: of the forward one only). Under
AUM_SCAN_FUSE_DT=1 (read at every forward, as the JAX mixer reads it at
every trace) the bimamba mixers leave dt_proj to the dual scan: delta's
slots hold None and the dt-rank columns of x_proj's output go with the
dt_proj weight as the scan's ``dt_fold`` (v1 one pair for both directions,
v2 each branch its own); Fo-Fo never folds. With
``split_remat`` it runs under ``torch.utils.checkpoint`` and is recomputed in
the backward, while the scan's saved tensors (its inputs and chunk-entry
states) stay outside the checkpoint, as the JAX ``remat_mode="split"`` does.

The parallel modes (``parallel/mesh.py::shard_params`` sets them): with
``tp_group`` the mixer holds its rank's shard of d_inner (tensor
parallelism, the JAX mixer's ``model_axis``), and three collectives per
mixer make it whole: the input to in_proj is copied in (identity forward,
the ranks' grads summed backward, as each rank's in_proj sees only its
channels); x_proj's output ``x_dbl`` is summed over the ranks forward and
its grad summed backward too, because its consumers (the rank's dt_proj
columns, B and C in the rank's channels' scan) are per-rank; out_proj's
output is summed forward and passed through backward. A wrong rule here
(Megatron's two-operator recipe, identity backward at ``x_dbl``) shows in
the grads against JAX. With ``seq_group`` (sequence parallelism, the JAX
mixer's ``seq_axis``) each direction's scan goes through
``ops/seq_parallel.py::sharded_scan`` and the dual kernel is off, as in JAX:
a Fo-Bi mixer runs two single-direction scans with carried state. Under
split remat the checkpointed ``pre_scan`` runs its all-reduce again in the
backward; every rank recomputes in the same order (``use_reentrant=False``).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from aum_tpu_torch.ops import (
    causal_conv1d,
    causal_conv1d_update,
    fused_add_norm,
    rms_norm,
    selective_scan,
    selective_scan_dual,
    selective_state_update,
)
from aum_tpu_torch.ops.selective_scan import fuse_dt_chosen
from aum_tpu_torch.ops.seq_parallel import sharded_scan
from aum_tpu_torch.parallel import collectives
D_CONV = 4
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
    """Selective-SSM mixer (one direction, or a direction pair) for one block."""

    def __init__(self, d_model: int, d_state: int = 16, bimamba_type: str = "v2",
                 n_layer: int = 24, d_conv: int = D_CONV, expand: int = EXPAND,
                 if_devide_out: bool = True, init_layer_scale: float | None = None,
                 dt_rank: int | None = None, bcdt_norms: bool = False, norm_eps: float = 1e-6):
        super().__init__()
        if bimamba_type not in ("none", "v1", "v2"):
            raise ValueError(f"unknown bimamba_type: {bimamba_type}")
        self.if_devide_out = if_devide_out
        self.init_layer_scale = init_layer_scale
        self.d_model = d_model
        self.d_state = d_state
        self.d_conv = d_conv
        self.d_inner = expand * d_model
        self.dt_rank = math.ceil(d_model / 16) if dt_rank is None else dt_rank
        self.bimamba_type = bimamba_type
        self.bcdt_norms = bcdt_norms
        self.norm_eps = norm_eps
        self.n_layer = n_layer
        self.tp_group = None  # set by parallel/mesh.py::shard_params
        self.seq_group = None
        d_in = self.d_inner

        self.in_proj = _Weights((2 * d_in, d_model))
        self._add_branch("")
        if bimamba_type != "none":
            self.A_b_log = nn.Parameter(torch.empty((d_in, d_state)))
        if bimamba_type == "v2":
            self._add_branch("_b")
        self.out_proj = _Weights((d_model, d_in))
        if init_layer_scale is not None:
            self.gamma = nn.Parameter(torch.empty((d_model,)))
        if bcdt_norms:
            if bimamba_type != "none":
                raise ValueError("the dt/B/C norms are Jamba's: bimamba_type must be 'none'")
            self.dt_layernorm = _Weights((self.dt_rank,))
            self.b_layernorm = _Weights((d_state,))
            self.c_layernorm = _Weights((d_state,))

    def _add_branch(self, suffix: str) -> None:
        d_in, rank = self.d_inner, self.dt_rank
        self.add_module(f"conv1d{suffix}", _Weights((d_in, 1, self.d_conv), (d_in,)))
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
            _uniform_fan_in_(conv.weight, self.d_conv, generator)
            _uniform_fan_in_(conv.bias, self.d_conv, generator)
            _uniform_fan_in_(getattr(self, f"x_proj{s}").weight, d_in, generator)
            dt_proj = getattr(self, f"dt_proj{s}")
            _uniform_fan_in_(dt_proj.weight, self.dt_rank, generator)
            _dt_bias_(dt_proj.bias, generator)
            nn.init.ones_(getattr(self, f"D{s}"))
        _a_log_(self.A_log)
        if self.bimamba_type != "none":
            _a_log_(self.A_b_log)
        _uniform_fan_in_(self.out_proj.weight, d_in, generator,
                         scale=1.0 / math.sqrt(self.n_layer))
        if self.init_layer_scale is not None:
            nn.init.constant_(self.gamma, self.init_layer_scale)
        if self.bcdt_norms:
            for norm in (self.dt_layernorm, self.b_layernorm, self.c_layernorm):
                nn.init.ones_(norm.weight)

    def split_x_dbl(self, x_dbl: torch.Tensor, dtype: torch.dtype):
        """x_proj's output -> (dt-rank columns, B, C): strided views, or with
        ``bcdt_norms`` each through its RMSNorm (fp32 arithmetic, out in
        ``dtype``)."""
        r, n = self.dt_rank, self.d_state
        parts = (x_dbl[..., :r], x_dbl[..., r:r + n], x_dbl[..., r + n:])
        if not self.bcdt_norms:
            return parts
        norms = (self.dt_layernorm, self.b_layernorm, self.c_layernorm)
        return tuple(rms_norm(t, m.weight.to(dtype), self.norm_eps) for t, m in zip(parts, norms))

    def _branch(self, xs: torch.Tensor, suffix: str, reverse_conv: bool, fold: bool):
        """conv -> x_proj -> dt_proj: (u, delta, B, C, None) for one scan
        direction, or with ``fold`` (u, None, B, C, (dtr, W)): the dt-rank
        columns and the (R, D) dt_proj weight in delta's place."""
        dtype = xs.dtype
        conv = getattr(self, f"conv1d{suffix}")
        xc = causal_conv1d(xs, conv.weight[:, 0].to(dtype), conv.bias.to(dtype),
                           activation="silu", reverse=reverse_conv)
        x_dbl = collectives.reduce_both(
            xc @ getattr(self, f"x_proj{suffix}").weight.to(dtype).t(), self.tp_group,
            tag="tp_x_dbl")
        w_dt = getattr(self, f"dt_proj{suffix}").weight.to(dtype).t()
        dtr, bm, cm = self.split_x_dbl(x_dbl, dtype)
        if fold:
            return xc, None, bm, cm, (dtr, w_dt)
        return xc, dtr @ w_dt, bm, cm, None

    def pre_scan(self, x: torch.Tensor):
        """In-projection, conv, x/dt projections: the scan arguments (u,
        delta, A, B, C, D, z, delta_bias) of the forward direction, and for
        v1/v2 also of the reverse one and the scan's ``dt_fold`` (None unless
        AUM_SCAN_FUSE_DT=1), as a triple."""
        dtype = x.dtype
        d_in = self.in_proj.weight.shape[0] // 2  # this rank's channels under TP
        fold = self.bimamba_type != "none" and self.seq_group is None and fuse_dt_chosen()
        x = collectives.copy_to_group(x, self.tp_group, tag="tp_input")
        xz = x @ self.in_proj.weight.to(dtype).t()
        xs, z = xz[..., :d_in], xz[..., d_in:]
        u, delta, bm, cm, pair = self._branch(xs, "", reverse_conv=False, fold=fold)
        a = -torch.exp(self.A_log.float())
        dt_bias = self.dt_proj.bias.float()
        args_f = (u, delta, a, bm, cm, self.D.float(), z, dt_bias)
        if self.bimamba_type == "none":
            return args_f
        if self.bimamba_type == "v1":
            args_r = (u, delta, -torch.exp(self.A_b_log.float()), bm, cm,
                      args_f[5], z, dt_bias)
            pair_b = pair
        else:
            u_b, delta_b, bm_b, cm_b, pair_b = self._branch(xs, "_b", reverse_conv=True,
                                                            fold=fold)
            args_r = (u_b, delta_b, -torch.exp(self.A_b_log.float()), bm_b, cm_b,
                      self.D_b.float(), z, self.dt_proj_b.bias.float())
        return args_f, args_r, (pair, pair_b) if fold else None

    def forward(self, x: torch.Tensor, split_remat: bool = False) -> torch.Tensor:
        """x: (B, L, d_model) in the compute dtype. ``split_remat``
        checkpoints ``pre_scan`` when a grad is being taken."""
        dtype = x.dtype
        if split_remat and torch.is_grad_enabled():
            args = checkpoint(self.pre_scan, x, use_reentrant=False)
        else:
            args = self.pre_scan(x)
        if self.seq_group is not None:
            scan = functools.partial(sharded_scan, group=self.seq_group)
        else:
            scan = functools.partial(selective_scan, delta_softplus=True)
        if self.bimamba_type == "none":
            y = scan(*args)
        else:
            if self.seq_group is not None:
                y_f, y_b = scan(*args[0]), scan(*args[1], reverse=True)
            else:
                y_f, y_b = selective_scan_dual(*args)
            y = y_f + y_b  # in the compute dtype, as XLA sums it
            if self.bimamba_type == "v2" and self.if_devide_out:
                y = y / 2
        out = collectives.reduce_from_group(y @ self.out_proj.weight.to(dtype).t(),
                                            self.tp_group, tag="tp_out")
        if self.init_layer_scale is not None:
            out = out * self.gamma.to(dtype)
        return out

    def prefill(self, x: torch.Tensor):
        """The Fo-Fo mixer over a prompt x (B, L, d_model) in the compute
        dtype -> (out (B, L, d_model), conv cache (B, d_inner, d_conv) fp32:
        the last d_conv pre-conv inputs, oldest first, left-padded with zeros
        for a prompt shorter than d_conv, SSM state (B, d_inner, d_state)
        fp32: the scan's final state)."""
        dtype = x.dtype
        seqlen, d_in = x.shape[1], self.d_inner
        kpad = max(self.d_conv - seqlen, 0)
        xz = x @ self.in_proj.weight.to(dtype).t()
        xs, z = xz[..., :d_in], xz[..., d_in:]
        u, delta, bm, cm, _ = self._branch(xs, "", reverse_conv=False, fold=False)
        y, ssm = selective_scan(u, delta, -torch.exp(self.A_log.float()), bm, cm,
                                self.D.float(), z, delta_bias=self.dt_proj.bias.float(),
                                delta_softplus=True, return_final_state=True)
        tail = torch.nn.functional.pad(xs[:, seqlen - (self.d_conv - kpad):].float(),
                                       (0, 0, kpad, 0))
        return y @ self.out_proj.weight.to(dtype).t(), tail.transpose(1, 2), ssm

    def step(self, x: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor):
        """One token x (B, d_model) in the compute dtype on the caches ->
        (out (B, d_model), new conv cache, new SSM state). The conv, the x and
        dt projections and the state update run in fp32, as the JAX step
        runs them."""
        dtype = x.dtype
        d_in = self.d_inner
        xz = x @ self.in_proj.weight.to(dtype).t()
        xs, z = xz[..., :d_in], xz[..., d_in:]
        xc, conv = causal_conv1d_update(xs.float(), conv_state, self.conv1d.weight[:, 0].float(),
                                        self.conv1d.bias.float())
        dtr, bm, cm = self.split_x_dbl(xc @ self.x_proj.weight.float().t(), torch.float32)
        y, ssm = selective_state_update(
            ssm_state, xc, dtr @ self.dt_proj.weight.float().t(), -torch.exp(self.A_log.float()),
            bm, cm, self.D.float(), z=z, dt_bias=self.dt_proj.bias.float(), dt_softplus=True)
        return y.to(dtype) @ self.out_proj.weight.to(dtype).t(), conv, ssm


class MambaBlock(nn.Module):
    """Add -> Norm -> Mixer block, an fp32 residual stream by default.

    Takes (hidden, residual), returns (mixer_out, residual + hidden), the norm
    applied to the residual sum (the reference Block's contract).
    """

    def __init__(self, d_model: int, norm_epsilon: float = 1e-5,
                 bimamba_type: str = "v2", d_state: int = 16, n_layer: int = 24,
                 d_conv: int = D_CONV, expand: int = EXPAND, rms_norm: bool = True,
                 residual_in_fp32: bool = True, if_devide_out: bool = True,
                 init_layer_scale: float | None = None):
        super().__init__()
        self.norm_epsilon = norm_epsilon
        self.rms_norm = rms_norm
        self.residual_in_fp32 = residual_in_fp32
        self.norm = _Weights((d_model,), None if rms_norm else (d_model,))
        self.mixer = MambaMixer(d_model, d_state=d_state, bimamba_type=bimamba_type,
                                n_layer=n_layer, d_conv=d_conv, expand=expand,
                                if_devide_out=if_devide_out,
                                init_layer_scale=init_layer_scale)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.norm.weight)
        if self.norm.bias is not None:
            nn.init.zeros_(self.norm.bias)
        self.mixer.reset_parameters(generator)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor | None,
                dtype: torch.dtype, split_remat: bool = False):
        normed, residual = fused_add_norm(  # the bias stays fp32, as in JAX
            hidden, self.norm.weight.to(dtype), self.norm.bias, residual=residual,
            prenorm=True, eps=self.norm_epsilon,
            norm_type="rms" if self.rms_norm else "layer",
            residual_in_fp32=self.residual_in_fp32)
        return self.mixer(normed, split_remat=split_remat), residual
