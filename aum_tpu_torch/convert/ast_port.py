"""timm DeiT and reference AST checkpoints -> ``ASTModel`` state dicts.

Counterpart of ``aum_tpu/convert/ast_port.py``, the reference AST's
pretrained-init surgery. ``ASTModel``'s module tree is the reference AST
audio checkpoint's layout, so this is key surgery:

- a timm DeiT: the patch kernel summed over its RGB channels to one; the
  pos embed retargeted from its (square) image grid to the AST grid by a
  centre crop or a bilinear interpolation per axis; the keys moved under
  ``v.``; the head left to the model's init (``merge_with_init``);
- a reference AST audio checkpoint (the DeiT under ``v.``, LayerNorm +
  Linear under ``mlp_head.``): ``module.`` stripped, the pos embed
  retargeted from the pretrain grid, the ``mlp_head`` kept only when its
  class count is the config's.

The pos-embed retarget runs in numpy float64 as the JAX package runs it, and
the result is rounded to fp32 once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from aum_tpu_torch.convert.torch_port import _f32, _strip_module, export_aum_state_dict
from aum_tpu_torch.models.ast import retarget_pos_embed

_BLOCK_KEYS = tuple(f"{m}.{p}" for m in ("attn.qkv", "attn.proj", "norm1", "norm2", "mlp.fc1",
                                         "mlp.fc2") for p in ("weight", "bias"))


def _np32(v) -> np.ndarray:
    return _f32(v).numpy()


def port_deit_state_dict(sd: Dict, cfg, source_grid: tuple | None = None
                         ) -> Dict[str, torch.Tensor]:
    """A timm DeiT state dict -> the encoder of ``ASTModel(cfg)`` (``v.``
    keys; no head). ``source_grid`` is the (f, t) grid of the checkpoint's
    pos embed; None means a square ImageNet grid, inferred from the token
    count, and a count that is not a square raises (a token count alone
    cannot tell a non-square grid)."""
    proj_w = _np32(sd["patch_embed.proj.weight"])  # (D, C, ph, pw)
    if proj_w.shape[1] == 3:
        proj_w = proj_w.sum(axis=1, keepdims=True)  # the reference sums RGB
    pos = _np32(sd["pos_embed"])
    n_prefix = cfg.num_prefix
    n_tok = pos.shape[1] - n_prefix
    if source_grid is None:
        side = int(round(n_tok ** 0.5))
        if side * side != n_tok:
            raise ValueError(
                f"pos_embed has {n_tok} tokens — not a square grid; pass source_grid=(f, t) "
                "(or go through port_ast_pretrain_state_dict's pretrain_grid)")
        source_grid = (side, side)
    if tuple(source_grid) != tuple(cfg.patch_grid):
        pos = retarget_pos_embed(pos, tuple(source_grid), tuple(cfg.patch_grid), n_prefix)
    out = {"v.patch_embed.proj.weight": proj_w,
           "v.patch_embed.proj.bias": sd["patch_embed.proj.bias"],
           "v.cls_token": sd["cls_token"], "v.pos_embed": pos,
           "v.norm.weight": sd["norm.weight"], "v.norm.bias": sd["norm.bias"]}
    if cfg.distilled and "dist_token" in sd:
        out["v.dist_token"] = sd["dist_token"]
    for i in range(cfg.depth):
        for k in _BLOCK_KEYS:
            out[f"v.blocks.{i}.{k}"] = sd[f"blocks.{i}.{k}"]
    return {k: _f32(v) for k, v in out.items()}


# An ASTModel's weights as the reference AST audio checkpoint, which
# ``port_ast_pretrain_state_dict`` and the reference's audio-pretrain load
# read: the same copy as the AuM export, ASTModel's tree being that layout.
export_ast_state_dict = export_aum_state_dict


def port_ast_pretrain_state_dict(sd: Dict, cfg, pretrain_grid: tuple | None = None
                                 ) -> Dict[str, torch.Tensor]:
    """A reference AST audio checkpoint -> the state dict of
    ``ASTModel(cfg)``: ``module.`` stripped, the ``v.`` encoder's pos embed
    retargeted from ``pretrain_grid`` (None: a square grid, or AST's
    128 x 1024 at stride 10, (12, 101), read from the token count), the
    ``mlp_head`` kept when its class count is ``cfg.label_dim``."""
    sd = _strip_module(sd)
    deit = {k[len("v."):]: v for k, v in sd.items() if k.startswith("v.")}
    n_tok = deit["pos_embed"].shape[1] - cfg.num_prefix
    if pretrain_grid is None:
        side = round(n_tok ** 0.5)
        if side * side == n_tok:
            pretrain_grid = (side, side)
        elif n_tok == 12 * 101:
            pretrain_grid = (12, 101)
        else:
            raise ValueError(f"cannot infer pretrain grid for {n_tok} tokens; "
                             "pass pretrain_grid=(f, t)")
    if tuple(pretrain_grid) != tuple(cfg.patch_grid):
        deit["pos_embed"] = retarget_pos_embed(_np32(deit["pos_embed"]), tuple(pretrain_grid),
                                               tuple(cfg.patch_grid), cfg.num_prefix)
    out = port_deit_state_dict(deit, cfg, source_grid=cfg.patch_grid)
    if "mlp_head.1.weight" in sd and sd["mlp_head.1.weight"].shape[0] == cfg.label_dim:
        for k in ("mlp_head.0.weight", "mlp_head.0.bias", "mlp_head.1.weight",
                  "mlp_head.1.bias"):
            out[k] = _f32(sd[k])
    return out
