"""JAX parameter trees -> this package's state dicts.

``state_dict_from_jax`` is the counterpart of
``aum_tpu/convert/torch_port.py::export_aum_state_dict``: it takes the JAX
package's AudioMamba parameter tree as numpy arrays (what
``jax.device_get(params)`` gives) and returns the upstream reference's
state-dict layout, which is also this package's module tree, so the result
loads into ``AudioMamba`` with ``strict=True``. ``lm_state_dict_from_jax``
does the same for the Mamba LM (the inverse of
``models/lm.py::port_lm_state_dict``), and ``ast_state_dict_from_jax`` for
the AST baseline (the counterpart of
``aum_tpu/convert/ast_port.py::export_ast_state_dict``: the reference AST
audio checkpoint's layout, which is ``models/ast.py::ASTModel``'s module
tree). Layout translation:

- linear weights (in, out) -> (out, in); the JAX package's separate x/z
  in-projections concatenate into the reference's single ``in_proj``;
- the patch kernel HWIO -> OIHW; depthwise conv taps (D, K) -> (D, 1, K);
- the stacked layer axis unstacks into ``layers.{i}``;
- flax attention's per-head query, key and value kernels (D, H, Dh) fuse
  back into one ``qkv`` (3D, D), its out kernel (H, Dh, D) into ``proj``;
- the parameters of the non-default config fields go along: the
  LayerNorm biases of ``rms_norm=False`` (``layers.{i}.norm.bias``,
  ``norm_f.bias``, which the JAX exporter leaves out) and LayerScale's
  ``gamma``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _mixer_to_torch(m: Dict, j: int, bt: str) -> Dict:
    """Layer j of a stacked mixer dict in the reference layout."""
    g = lambda k: np.asarray(m[k][j], np.float32)  # noqa: E731
    out = {
        "in_proj.weight": np.concatenate(
            [g("in_proj_x_weight").T, g("in_proj_z_weight").T], axis=0),
        "conv1d.weight": g("conv1d_weight")[:, None, :],
        "conv1d.bias": g("conv1d_bias"),
        "x_proj.weight": g("x_proj_weight").T,
        "dt_proj.weight": g("dt_proj_weight").T,
        "dt_proj.bias": g("dt_proj_bias"),
        "A_log": g("A_log"),
        "D": g("D"),
        "out_proj.weight": g("out_proj_weight").T,
    }
    if bt in ("v1", "v2"):
        out["A_b_log"] = g("A_b_log")
    if bt == "v2":
        out.update({
            "conv1d_b.weight": g("conv1d_b_weight")[:, None, :],
            "conv1d_b.bias": g("conv1d_b_bias"),
            "x_proj_b.weight": g("x_proj_b_weight").T,
            "dt_proj_b.weight": g("dt_proj_b_weight").T,
            "dt_proj_b.bias": g("dt_proj_b_bias"),
            "D_b": g("D_b"),
        })
    if "gamma" in m:
        out["gamma"] = g("gamma")
    return out


def _unstack_block(block: Dict, layer_ids, bt: str, out: Dict) -> None:
    for j, i in enumerate(layer_ids):
        out[f"layers.{i}.norm.weight"] = np.asarray(block["norm_weight"][j], np.float32)
        if "norm_bias" in block:  # rms_norm=False: a LayerNorm
            out[f"layers.{i}.norm.bias"] = np.asarray(block["norm_bias"][j], np.float32)
        for k, v in _mixer_to_torch(block["mixer"], j, bt).items():
            out[f"layers.{i}.mixer.{k}"] = v


def state_dict_from_jax(params_np: Dict, cfg) -> Dict[str, torch.Tensor]:
    """JAX AudioMamba params (numpy leaves) -> reference-layout fp32 tensors.

    ``cfg`` is an ``AudioMambaConfig`` (this package's or the JAX one: only
    the cls-token, ``bimamba_type``, ``depth`` and ``if_bidirectional``
    fields are read).
    """
    p = params_np.get("params", params_np)
    sd: Dict = {
        "patch_embed.proj.weight": np.transpose(
            np.asarray(p["patch_embed"]["proj_weight"], np.float32), (3, 2, 0, 1)),
        "patch_embed.proj.bias": np.asarray(p["patch_embed"]["proj_bias"], np.float32),
        "pos_embed.pos_embed": np.asarray(p["pos_embed"]["pos_embed"], np.float32),
        "norm_f.weight": np.asarray(p["norm_f_weight"], np.float32),
    }
    if "norm_f_bias" in p:
        sd["norm_f.bias"] = np.asarray(p["norm_f_bias"], np.float32)
    if cfg.if_cls_token:
        if cfg.use_double_cls_token:
            sd["cls_token_head"] = np.asarray(p["cls_token_head"], np.float32)
            sd["cls_token_tail"] = np.asarray(p["cls_token_tail"], np.float32)
        else:
            sd["cls_token"] = np.asarray(p["cls_token"], np.float32)
    if "head_weight" in p:
        sd["head.weight"] = np.asarray(p["head_weight"], np.float32).T
        sd["head.bias"] = np.asarray(p["head_bias"], np.float32)
    bt = cfg.bimamba_type
    if cfg.if_bidirectional:
        _unstack_block(p["layers"]["fwd"], range(0, cfg.depth, 2), bt, sd)
        _unstack_block(p["layers"]["bwd"], range(1, cfg.depth, 2), bt, sd)
    else:
        _unstack_block(p["layers"]["block"], range(cfg.depth), bt, sd)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def lm_state_dict_from_jax(params_np: Dict, cfg) -> Dict[str, torch.Tensor]:
    """The JAX package's Mamba LM params (``MambaLM`` / ``port_lm_state_dict``'s
    ``{'params': {...}}``, numpy leaves) -> this package's ``MambaLM`` state
    dict (the reference ``MambaLMHeadModel``'s keys, fp32): the stacked
    layer axis unstacked, (in, out) matmul weights transposed back, the x and
    z halves rejoined into ``in_proj``, the conv's channel axis restored.
    ``cfg``: an ``MambaLMConfig`` of either package (``n_layer`` is read)."""
    p = params_np.get("params", params_np)
    g = lambda k, i=None: np.asarray(p[k] if i is None else p[k][i], np.float32)  # noqa: E731
    sd = {"backbone.embedding.weight": g("embedding"),
          "backbone.norm_f.weight": g("norm_f_weight")}
    for i in range(cfg.n_layer):
        pre = f"backbone.layers.{i}."
        sd.update({
            pre + "norm.weight": g("norm_weight", i),
            pre + "mixer.in_proj.weight": np.concatenate(
                [g("in_proj_x", i).T, g("in_proj_z", i).T], axis=0),
            pre + "mixer.conv1d.weight": g("conv_w", i)[:, None, :],
            pre + "mixer.conv1d.bias": g("conv_b", i),
            pre + "mixer.x_proj.weight": g("x_proj", i).T,
            pre + "mixer.dt_proj.weight": g("dt_w", i).T,
            pre + "mixer.dt_proj.bias": g("dt_b", i),
            pre + "mixer.A_log": g("A_log", i),
            pre + "mixer.D": g("D", i),
            pre + "mixer.out_proj.weight": g("out_proj", i).T,
        })
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def ast_state_dict_from_jax(params_np: Dict, cfg) -> Dict[str, torch.Tensor]:
    """The JAX package's ASTModel params (numpy leaves) -> this package's
    ``ASTModel`` state dict (the reference AST audio checkpoint's keys:
    the DeiT encoder under ``v.``, LayerNorm + Linear under ``mlp_head.``),
    fp32. ``cfg``: an ``ASTConfig`` of either package (``embed_dim`` and
    ``depth`` are read)."""
    p = params_np.get("params", params_np)
    d = cfg.embed_dim
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    sd: Dict = {
        "v.patch_embed.proj.weight": np.transpose(f32(p["patch_proj_weight"]), (3, 2, 0, 1)),
        "v.patch_embed.proj.bias": f32(p["patch_proj_bias"]),
        "v.cls_token": f32(p["cls_token"]),
        "v.pos_embed": f32(p["pos_embed"]),
        "v.norm.weight": f32(p["norm"]["scale"]),
        "v.norm.bias": f32(p["norm"]["bias"]),
    }
    if "dist_token" in p:
        sd["v.dist_token"] = f32(p["dist_token"])
    for i in range(cfg.depth):
        b, v = p[f"block_{i}"], f"v.blocks.{i}."
        attn = b["attn"]
        sd[v + "attn.qkv.weight"] = np.concatenate(
            [f32(attn[k]["kernel"]).reshape(d, d).T for k in ("query", "key", "value")])
        sd[v + "attn.qkv.bias"] = np.concatenate(
            [f32(attn[k]["bias"]).reshape(d) for k in ("query", "key", "value")])
        sd[v + "attn.proj.weight"] = f32(attn["out"]["kernel"]).reshape(d, d).T
        sd[v + "attn.proj.bias"] = f32(attn["out"]["bias"])
        for name in ("norm1", "norm2"):
            sd[v + name + ".weight"] = f32(b[name]["scale"])
            sd[v + name + ".bias"] = f32(b[name]["bias"])
        for name in ("fc1", "fc2"):
            sd[v + "mlp." + name + ".weight"] = f32(b[name]["kernel"]).T
            sd[v + "mlp." + name + ".bias"] = f32(b[name]["bias"])
    sd["mlp_head.0.weight"] = f32(p["head_norm"]["scale"])
    sd["mlp_head.0.bias"] = f32(p["head_norm"]["bias"])
    sd["mlp_head.1.weight"] = f32(p["head"]["kernel"]).T
    sd["mlp_head.1.bias"] = f32(p["head"]["bias"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
