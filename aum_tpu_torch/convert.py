"""JAX parameter tree -> this package's state dict.

Counterpart of ``aum_tpu/convert/torch_port.py::export_aum_state_dict``: it
takes the JAX package's parameter tree as numpy arrays (what
``jax.device_get(params)`` gives) and returns the upstream reference's
state-dict layout, which is also this package's module tree, so the result
loads into ``AudioMamba`` with ``strict=True``. Layout translation:

- linear weights (in, out) -> (out, in); the JAX package's separate x/z
  in-projections concatenate into the reference's single ``in_proj``;
- the patch kernel HWIO -> OIHW; depthwise conv taps (D, K) -> (D, 1, K);
- the stacked layer axis unstacks into ``layers.{i}``.
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
