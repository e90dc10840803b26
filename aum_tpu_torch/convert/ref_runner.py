"""Run the upstream Audio-Mamba-AuM code on CPU (or CUDA) torch, without its
CUDA/Triton extensions.

Counterpart of ``aum_tpu/convert/ref_runner.py``, with the same public names.
The upstream model code (``src/models/mamba_models.py``,
``vim-mamba_ssm/mamba_ssm/modules/mamba_simple.py``) guards every import of a
fused CUDA/Triton op with try/except. What those guards would leave as
``None`` is pre-filled in ``sys.modules`` with *independently written* torch
oracles of the fused ops, so the upstream Python itself (module
construction, init formulas, checkpoint surgery, the forward) runs end to
end and can be held against this package.

The oracles are written without this package's ops (``aum_tpu_torch.ops``):
a parity check through them would otherwise compare the port with itself.
Their math re-derives the sequential SSM recurrence
(``aum_tpu_torch/ops/scan_ref.py`` states the same), their call signatures
follow the upstream interfaces (``selective_scan_interface.py``,
``triton/layernorm.py``) and their layouts are upstream's: x (B, D, L),
B and C (B, N, L) or (B, 1, N, L). They run on the device of their inputs,
and torch.autograd gives their gradients.

Stubbed third-party modules the upstream imports unconditionally: ``timm``
(only ``to_2tuple``, ``trunc_normal_``, ``lecun_normal_``, ``DropPath``) and
``wget`` (never called on the paths run here).

The upstream checkout is looked for at ``$AUM_REFERENCE_PATH``, read at
every call, else at ``reference/`` in the repository root. None is shipped:
``reference_available()`` says whether one is there.
"""

from __future__ import annotations

import os
import sys
import types

# Set on the stubbed selective-scan interface module: its presence makes
# ``install_reference_stubs`` a no-op.
ORACLE_MARKER = "_aum_tpu_torch_oracle"


def reference_root() -> str:
    """The upstream checkout: ``$AUM_REFERENCE_PATH``, else ``reference/``
    beside this package."""
    default = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "reference")
    return os.environ.get("AUM_REFERENCE_PATH") or default


def reference_available() -> bool:
    return os.path.isdir(os.path.join(reference_root(), "src", "models"))


# --------------------------------------------------------------------------
# Torch oracles for the fused CUDA/Triton ops
# --------------------------------------------------------------------------


def _build_oracle_modules():
    import torch
    import torch.nn.functional as F

    def _silu(x):
        return x * torch.sigmoid(x)

    # -- causal_conv1d package (depthwise causal conv, k=d_conv) ------------

    def causal_conv1d_fn(x, weight, bias=None, activation=None, **_):
        """x: (B, D, L); weight: (D, W). Left-pad W-1, crop to L.
        Mirrors causal_conv1d_fn semantics (mamba_simple.py:271-280)."""
        l = x.shape[-1]
        d, w = weight.shape
        out = F.conv1d(x, weight.unsqueeze(1), bias, padding=w - 1,
                       groups=d)[..., :l]
        return _silu(out) if activation in ("silu", "swish") else out

    def causal_conv1d_update(x, conv_state, weight, bias=None,
                             activation=None):
        """Single-token conv step (mamba_simple.py:320-334 fallback math)."""
        with torch.no_grad():
            conv_state.copy_(torch.roll(conv_state, shifts=-1, dims=-1))
            conv_state[:, :, -1] = x
        out = (conv_state * weight.unsqueeze(0)).sum(dim=-1)
        if bias is not None:
            out = out + bias
        return _silu(out) if activation in ("silu", "swish") else out

    # -- selective scan ------------------------------------------------------

    def selective_scan_fn(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                          delta_softplus=False, return_last_state=False):
        """Sequential-oracle of the SSM recurrence (scan_ref.py semantics:
        x_t = exp(dt_t A) x_{t-1} + dt_t B_t u_t; y_t = C_t.x_t + D u_t,
        gated by silu(z)). B/C accepted as (B,N,L) or (B,1,N,L)."""
        dtype_in = u.dtype
        u = u.float()
        delta = delta.float()
        if delta_bias is not None:
            delta = delta + delta_bias.float()[None, :, None]
        if delta_softplus:
            delta = F.softplus(delta)
        if B.dim() == 4:
            B = B[:, 0]
        if C.dim() == 4:
            C = C[:, 0]
        B = B.float()
        C = C.float()
        A = A.float()
        bsz, d, l = u.shape
        n = A.shape[1]
        dA = torch.exp(delta.unsqueeze(-1) * A[None, :, None, :])  # (b,d,l,n)
        dBu = (delta * u).unsqueeze(-1) * B.transpose(1, 2).unsqueeze(1)
        x = u.new_zeros(bsz, d, n)
        ys = []
        for t in range(l):
            x = dA[:, :, t] * x + dBu[:, :, t]
            ys.append(torch.einsum("bdn,bn->bd", x, C[:, :, t]))
        y = torch.stack(ys, dim=-1)                      # (b, d, l)
        if D is not None:
            y = y + u * D.float()[None, :, None]
        if z is not None:
            y = y * _silu(z.float())
        y = y.to(dtype_in)
        return (y, x) if return_last_state else y

    def _inner_scan(xz, conv1d_weight, conv1d_bias, x_proj_weight,
                    delta_proj_weight, A, B, C, D, delta_bias,
                    delta_softplus):
        """Shared body of the mamba_inner_* fns: conv -> x_proj -> scan.
        Matches MambaInnerFnNoOutProj.forward's activations
        (selective_scan_interface.py:159-224)."""
        dt_rank = delta_proj_weight.shape[1]
        n = A.shape[1]
        x, z = xz.chunk(2, dim=1)
        w = conv1d_weight
        if w.dim() == 3:
            w = w.squeeze(1)
        xc = causal_conv1d_fn(x, w, conv1d_bias, activation="silu")
        x_dbl = torch.einsum("bdl,ed->bel", xc, x_proj_weight)
        delta = torch.einsum("brl,dr->bdl", x_dbl[:, :dt_rank],
                             delta_proj_weight)
        Bv = B if B is not None else x_dbl[:, dt_rank:dt_rank + n]
        Cv = C if C is not None else x_dbl[:, dt_rank + n:dt_rank + 2 * n]
        return selective_scan_fn(xc, delta, A, Bv, Cv, D, z=z,
                                 delta_bias=delta_bias,
                                 delta_softplus=delta_softplus)

    def mamba_inner_fn_no_out_proj(xz, conv1d_weight, conv1d_bias,
                                   x_proj_weight, delta_proj_weight, A,
                                   B=None, C=None, D=None, delta_bias=None,
                                   B_proj_bias=None, C_proj_bias=None,
                                   delta_softplus=True):
        assert B_proj_bias is None and C_proj_bias is None
        return _inner_scan(xz, conv1d_weight, conv1d_bias, x_proj_weight,
                           delta_proj_weight, A, B, C, D, delta_bias,
                           delta_softplus)

    def mamba_inner_fn(xz, conv1d_weight, conv1d_bias, x_proj_weight,
                       delta_proj_weight, out_proj_weight, out_proj_bias,
                       A, B=None, C=None, D=None, delta_bias=None,
                       B_proj_bias=None, C_proj_bias=None,
                       delta_softplus=True):
        y = mamba_inner_fn_no_out_proj(
            xz, conv1d_weight, conv1d_bias, x_proj_weight, delta_proj_weight,
            A, B, C, D, delta_bias, B_proj_bias, C_proj_bias, delta_softplus)
        return F.linear(y.transpose(1, 2), out_proj_weight, out_proj_bias)

    def bimamba_inner_fn(xz, conv1d_weight, conv1d_bias, x_proj_weight,
                         delta_proj_weight, out_proj_weight, out_proj_bias,
                         A, A_b, B=None, C=None, D=None, delta_bias=None,
                         B_proj_bias=None, C_proj_bias=None,
                         delta_softplus=True):
        """v1 bidirectional form (BiMambaInnerFn.forward, :441-517): shared
        conv/x_proj/delta activations; second scan over the flipped sequence
        with A_b and flipped z; summed before out_proj."""
        assert B_proj_bias is None and C_proj_bias is None
        dt_rank = delta_proj_weight.shape[1]
        n = A.shape[1]
        x, z = xz.chunk(2, dim=1)
        w = conv1d_weight
        if w.dim() == 3:
            w = w.squeeze(1)
        xc = causal_conv1d_fn(x, w, conv1d_bias, activation="silu")
        x_dbl = torch.einsum("bdl,ed->bel", xc, x_proj_weight)
        delta = torch.einsum("brl,dr->bdl", x_dbl[:, :dt_rank],
                             delta_proj_weight)
        Bv = B if B is not None else x_dbl[:, dt_rank:dt_rank + n]
        Cv = C if C is not None else x_dbl[:, dt_rank + n:dt_rank + 2 * n]
        y_f = selective_scan_fn(xc, delta, A, Bv, Cv, D, z=z,
                                delta_bias=delta_bias,
                                delta_softplus=delta_softplus)
        y_b = selective_scan_fn(
            xc.flip([-1]), delta.flip([-1]), A_b, Bv.flip([-1]),
            Cv.flip([-1]), D, z=z.flip([-1]), delta_bias=delta_bias,
            delta_softplus=delta_softplus)
        y = y_f + y_b.flip([-1])
        return F.linear(y.transpose(1, 2), out_proj_weight, out_proj_bias)

    # -- fused add+norm (triton/layernorm.py:464-502 contract) --------------

    def layer_norm_fn(x, weight, bias, residual=None, eps=1e-6,
                      prenorm=False, residual_in_fp32=False,
                      is_rms_norm=False):
        rdtype = (residual.dtype if residual is not None
                  else (torch.float32 if residual_in_fp32 else x.dtype))
        res = x.float() if residual is None else residual.float() + x.float()
        if is_rms_norm:
            rstd = torch.rsqrt(res.pow(2).mean(-1, keepdim=True) + eps)
            y = res * rstd * weight.float()
        else:
            mean = res.mean(-1, keepdim=True)
            xc = res - mean
            rstd = torch.rsqrt(xc.pow(2).mean(-1, keepdim=True) + eps)
            y = xc * rstd * weight.float()
        if bias is not None:
            y = y + bias.float()
        y = y.to(x.dtype)
        res = res.to(rdtype)
        return (y, res) if prenorm else y

    def rms_norm_fn(x, weight, bias, residual=None, prenorm=False,
                    residual_in_fp32=False, eps=1e-6):
        return layer_norm_fn(x, weight, bias, residual=residual, eps=eps,
                             prenorm=prenorm,
                             residual_in_fp32=residual_in_fp32,
                             is_rms_norm=True)

    class RMSNorm(torch.nn.Module):
        def __init__(self, hidden_size, eps=1e-5, device=None, dtype=None):
            super().__init__()
            self.eps = eps
            self.weight = torch.nn.Parameter(
                torch.ones(hidden_size, device=device, dtype=dtype))
            self.register_parameter("bias", None)

        def forward(self, x, residual=None, prenorm=False,
                    residual_in_fp32=False):
            return rms_norm_fn(x, self.weight, self.bias, residual=residual,
                               eps=self.eps, prenorm=prenorm,
                               residual_in_fp32=residual_in_fp32)

    return {
        "causal_conv1d_fn": causal_conv1d_fn,
        "causal_conv1d_update": causal_conv1d_update,
        "selective_scan_fn": selective_scan_fn,
        "mamba_inner_fn": mamba_inner_fn,
        "mamba_inner_fn_no_out_proj": mamba_inner_fn_no_out_proj,
        "bimamba_inner_fn": bimamba_inner_fn,
        "layer_norm_fn": layer_norm_fn,
        "rms_norm_fn": rms_norm_fn,
        "RMSNorm": RMSNorm,
    }


def oracle_mixer_forward(params: dict, hidden, bimamba_type: str = "v2",
                         if_devide_out: bool = True, oracles: dict | None = None):
    """The upstream ``Mamba.forward`` fast path (vim-mamba_ssm's
    ``mamba_simple.py``, no inference cache) through the oracles.

    ``params``: one mixer's weights under the upstream names
    (``in_proj.weight`` (2 d_inner, d_model), ``conv1d.weight`` (d_inner, 1,
    K), ``conv1d.bias``, ``x_proj.weight``, ``dt_proj.weight``,
    ``dt_proj.bias``, ``A_log``, ``D``, ``out_proj.weight``; ``A_b_log`` for
    v1 and v2; v2's ``conv1d_b.*``, ``x_proj_b.weight``, ``dt_proj_b.*``,
    ``D_b``). ``hidden``: (B, L, d_model). The weights are cast to hidden's
    dtype, but ``A_log``, ``D`` and the dt biases, which upstream passes in
    fp32. Fo-Fo ("none") is ``mamba_inner_fn``, Fo-Bi ("v1")
    ``bimamba_inner_fn``, Bi-Bi ("v2") two ``mamba_inner_fn_no_out_proj``
    calls, the second on the flipped sequence with the ``_b`` weights, summed
    (and halved with ``if_devide_out``) before out_proj. Returns (B, L,
    d_model) in hidden's dtype.
    """
    import torch
    import torch.nn.functional as F

    o = oracles or _build_oracle_modules()
    dtype = hidden.dtype

    def w(key):
        v = params.get(key)
        return None if v is None else v.to(dtype)

    def branch(s):
        return (w(f"conv1d{s}.weight"), w(f"conv1d{s}.bias"), w(f"x_proj{s}.weight"),
                w(f"dt_proj{s}.weight"))

    xz = torch.einsum("bld,ed->bel", hidden, w("in_proj.weight"))
    if params.get("in_proj.bias") is not None:
        xz = xz + w("in_proj.bias")[None, :, None]
    A = -torch.exp(params["A_log"].float())
    fwd = dict(D=params["D"].float(), delta_bias=params["dt_proj.bias"].float(),
               delta_softplus=True)
    if bimamba_type == "v1":
        A_b = -torch.exp(params["A_b_log"].float())
        return o["bimamba_inner_fn"](xz, *branch(""), w("out_proj.weight"),
                                     w("out_proj.bias"), A, A_b, None, None, **fwd)
    if bimamba_type == "v2":
        A_b = -torch.exp(params["A_b_log"].float())
        out = o["mamba_inner_fn_no_out_proj"](xz, *branch(""), A, None, None, **fwd)
        out_b = o["mamba_inner_fn_no_out_proj"](
            xz.flip([-1]), *branch("_b"), A_b, None, None, D=params["D_b"].float(),
            delta_bias=params["dt_proj_b.bias"].float(), delta_softplus=True)
        y = (out + out_b.flip([-1])).transpose(1, 2)
        if if_devide_out:
            y = y / 2
        return F.linear(y, w("out_proj.weight"), w("out_proj.bias"))
    return o["mamba_inner_fn"](xz, *branch(""), w("out_proj.weight"), w("out_proj.bias"),
                               A, None, None, **fwd)


# --------------------------------------------------------------------------
# sys.modules surgery
# --------------------------------------------------------------------------


def _stub(name: str, **attrs) -> types.ModuleType:
    import importlib.machinery

    mod = sys.modules.get(name)
    if mod is None:
        mod = types.ModuleType(name)
        # A real ModuleSpec so importlib.util.find_spec(name) (e.g.
        # transformers' availability probes) doesn't raise on the stub.
        mod.__spec__ = importlib.machinery.ModuleSpec(name, loader=None)
        mod.__path__ = []  # mark as package so submodule specs resolve
        sys.modules[name] = mod
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


def install_reference_stubs() -> None:
    """Idempotent: make the reference importable on CPU torch."""
    if hasattr(sys.modules.get("mamba_ssm.ops.selective_scan_interface"), ORACLE_MARKER):
        return

    import torch

    oracles = _build_oracle_modules()

    # timm: only these four symbols are used by the reference model code
    # (mamba_models.py:12-14, tokenization.py:9-16, rope.py:17).
    def to_2tuple(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v, v)

    def trunc_normal_(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0):
        with torch.no_grad():
            tensor.normal_(mean, std).clamp_(mean + a * std, mean + b * std)
        return tensor

    def lecun_normal_(tensor):
        fan_in = tensor.shape[1] * (
            tensor[0][0].numel() if tensor.dim() > 2 else 1)
        with torch.no_grad():
            tensor.normal_(0.0, (1.0 / max(fan_in, 1)) ** 0.5)
        return tensor

    class DropPath(torch.nn.Identity):
        def __init__(self, drop_prob=0.0):
            super().__init__()
            self.drop_prob = drop_prob

    timm = _stub("timm")
    timm_models = _stub("timm.models")
    timm_layers = _stub(
        "timm.models.layers", to_2tuple=to_2tuple,
        trunc_normal_=trunc_normal_, lecun_normal_=lecun_normal_,
        DropPath=DropPath)
    timm.models = timm_models
    timm_models.layers = timm_layers

    def _no_download(*a, **k):
        raise RuntimeError("wget stub: downloads disabled in this harness")

    _stub("wget", download=_no_download)

    _stub("causal_conv1d",
          causal_conv1d_fn=oracles["causal_conv1d_fn"],
          causal_conv1d_update=oracles["causal_conv1d_update"])

    # Pre-insert the fused-op interface modules the reference guards with
    # try/except: import machinery finds them in sys.modules, so the real
    # files (which import selective_scan_cuda / triton) never execute.
    _stub("mamba_ssm.ops.selective_scan_interface",
          **{ORACLE_MARKER: True},
          selective_scan_fn=oracles["selective_scan_fn"],
          mamba_inner_fn=oracles["mamba_inner_fn"],
          bimamba_inner_fn=oracles["bimamba_inner_fn"],
          mamba_inner_fn_no_out_proj=oracles["mamba_inner_fn_no_out_proj"])
    _stub("mamba_ssm.ops.triton.layernorm",
          RMSNorm=oracles["RMSNorm"],
          layer_norm_fn=oracles["layer_norm_fn"],
          rms_norm_fn=oracles["rms_norm_fn"])
    # None => mamba_simple.step falls back to its explicit torch math.
    _stub("mamba_ssm.ops.triton.selective_state_update",
          selective_state_update=None)


def _import_reference(module: str):
    root = reference_root()
    if not os.path.isdir(os.path.join(root, "src", "models")):
        raise RuntimeError(f"reference not found at {root}")
    install_reference_stubs()
    for p in (root, os.path.join(root, "vim-mamba_ssm")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import importlib

    return importlib.import_module(module)


def import_reference_models():
    """Import and return the upstream ``src.models.mamba_models`` module."""
    return _import_reference("src.models.mamba_models")


def reference_state_dict_numpy(model) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def import_reference_lm():
    """Import and return the upstream ``mamba_ssm.models.mixer_seq_simple``
    (``MambaLMHeadModel``) with the same oracle stubs as the audio models:
    the fused-op interfaces are pre-inserted in ``sys.modules``, so the
    CUDA/Triton files never execute."""
    return _import_reference("mamba_ssm.models.mixer_seq_simple")
