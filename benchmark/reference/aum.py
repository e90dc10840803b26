"""Plain fp32 reference of AudioMamba (AuM), after kaistmm/Audio-Mamba-AuM.

``logits(params, model, x)`` follows upstream's ``AudioMamba.forward_features``
and ``forward`` (``src/models/mamba_models.py``) for the settings the
benchmark's configurations use: the input (Bt, T, F) as (Bt, 1, F, T), the
patch Conv2d (flattened F-major), the middle cls token, the absolute position
embedding added with the cls token moved to the front and back
(``FlexiPosEmbed``), ``depth`` blocks of add -> RMSNorm -> Mamba mixer with an
fp32 residual stream, the final add -> RMSNorm, the cls readout and the head.
The mixer is Vim's ``mamba_simple.Mamba``: in_proj, the causal depthwise conv
(width ``d_conv``) with SiLU, x_proj, dt_proj, the selective scan, out_proj;
``bimamba_type`` "v1" adds the reverse scan over the same activations with
``A_b`` and sums the two, "none" runs the forward scan alone.

``params`` maps the upstream state-dict keys to tensors. ``rnd`` rounds at
the points the configuration computes in its compute dtype
(``precision.rounding``). With ``checkpoint_blocks`` each block is recomputed
in the backward, so a train step's reference fits the card. Imports only
torch and this package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.scan import selective_scan

SUPPORTED = {"rms_norm": True, "residual_in_fp32": True, "if_cls_token": True,
             "use_middle_cls_token": True, "use_double_cls_token": False,
             "use_end_cls_token": False, "if_abs_pos_embed": True, "if_rope": False,
             "if_bidirectional": False, "transpose_token_sequence": False,
             "init_layer_scale": None}


def _check(model: dict) -> None:
    for key, want in SUPPORTED.items():
        if key in model and model[key] != want:
            raise NotImplementedError(f"the reference has no {key}={model[key]!r}")
    if model["bimamba_type"] not in ("none", "v1"):
        raise NotImplementedError(f"bimamba_type {model['bimamba_type']!r}")


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight


def causal_conv_silu(x, weight, bias, rnd):
    """x (Bt, L, Dm); weight (Dm, 1, K): the depthwise causal conv of the
    channels-first layout, then SiLU."""
    k = weight.shape[-1]
    out = F.conv1d(x.transpose(1, 2), rnd(weight), rnd(bias), padding=k - 1,
                   groups=x.shape[-1])[..., :x.shape[1]]
    return rnd(F.silu(out).transpose(1, 2))


def mixer(p: dict, pre: str, hidden, model: dict, rnd):
    d_state = model["d_state"]
    w_in = rnd(p[pre + "in_proj.weight"])
    xz = rnd(hidden @ w_in.t())
    d_in = xz.shape[-1] // 2
    xs, z = xz[..., :d_in], xz[..., d_in:]
    xc = causal_conv_silu(xs, p[pre + "conv1d.weight"], p[pre + "conv1d.bias"], rnd)
    x_dbl = rnd(xc @ rnd(p[pre + "x_proj.weight"]).t())
    rank = p[pre + "dt_proj.weight"].shape[1]
    dtr, bm, cm = x_dbl.split([rank, d_state, d_state], dim=-1)
    delta = rnd(dtr @ rnd(p[pre + "dt_proj.weight"]).t())
    bias = p[pre + "dt_proj.bias"]
    a = -torch.exp(p[pre + "A_log"].float())
    y = rnd(selective_scan(xc, delta, a, bm, cm, p[pre + "D"], z, bias))
    if model["bimamba_type"] == "v1":
        a_b = -torch.exp(p[pre + "A_b_log"].float())
        y = rnd(y + rnd(selective_scan(xc, delta, a_b, bm, cm, p[pre + "D"], z, bias,
                                       reverse=True)))
    return rnd(y @ rnd(p[pre + "out_proj.weight"]).t())


def embed(p: dict, x, model: dict, rnd):
    """(Bt, T, F) log-mel -> (Bt, 1 + N, D) tokens with the cls token in the
    middle, position embedded."""
    w = p["patch_embed.proj.weight"]
    ph, pw = w.shape[-2:]
    sh, sw = model["strides"]
    img = rnd(x).transpose(1, 2)[:, None]                          # (Bt, 1, F, T)
    tok = F.conv2d(img, rnd(w), rnd(p["patch_embed.proj.bias"]), stride=(sh, sw))
    tok = rnd(tok.flatten(2).transpose(1, 2))                       # (Bt, N, D), F-major
    n = tok.shape[1]
    mid = n // 2
    cls = rnd(p["cls_token"]).expand(tok.shape[0], -1, -1)
    seq = torch.cat([tok[:, :mid], cls, tok[:, mid:]], dim=1)
    # FlexiPosEmbed: the cls token to the front, add, and back to the middle.
    front = torch.cat([seq[:, mid:mid + 1], seq[:, :mid], seq[:, mid + 1:]], dim=1)
    front = rnd(front + rnd(p["pos_embed.pos_embed"]))
    return torch.cat([front[:, 1:mid + 1], front[:, :1], front[:, mid + 1:]], dim=1), mid


def logits(p: dict, model: dict, x: torch.Tensor, rnd=lambda t: t.float(),
           checkpoint_blocks: bool = False) -> torch.Tensor:
    """(Bt, T, F) log-mel -> (Bt, num_classes) fp32 logits."""
    _check(model)
    eps = model.get("norm_epsilon", 1e-5)
    hidden, cls_at = embed(p, x, model, rnd)
    residual = torch.zeros_like(hidden)

    def block(i, hidden, residual):
        pre = f"layers.{i}."
        residual = residual + hidden
        normed = rnd(rms_norm(residual, p[pre + "norm.weight"].float(), eps))
        return mixer(p, pre + "mixer.", normed, model, rnd), residual

    for i in range(model["depth"]):
        if checkpoint_blocks and torch.is_grad_enabled():
            hidden, residual = checkpoint(block, i, hidden, residual, use_reentrant=False)
        else:
            hidden, residual = block(i, hidden, residual)
    feats = rnd(rms_norm(residual + hidden, p["norm_f.weight"].float(), eps))[:, cls_at]
    return rnd(feats @ rnd(p["head.weight"]).t() + rnd(p["head.bias"])).float()
