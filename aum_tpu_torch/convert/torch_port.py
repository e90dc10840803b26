"""Reference AuM / ViM ``.pth`` checkpoints -> this package's state dicts.

Counterpart of ``aum_tpu/convert/torch_port.py``. This package's module tree
is the reference's state-dict layout, so where the JAX package translates
layouts (transposes, the x/z split, stacked layers) these functions only do
the reference's checkpoint-loading surgery and return reference-layout fp32
tensors:

- the AuM pretrain load: the ``module.`` prefix stripped; the pretrain
  patch grid inferred by scanning audio lengths 2^6..2^19 at 128 mel bins
  (skipped when the token count already matches the target grid, which a
  donor with other than 128 mel bins needs); the pos embed bilinearly
  resampled to the target grid; the patch kernel PI-resized when the patch
  size differs; the head dropped on a class-count mismatch;
- the ImageNet ViM load: the ``pos_embed`` key moved, the RGB patch kernel
  averaged to one channel, the middle (or double) cls pos embed relocated
  into the prefix slot(s), the square grid resampled, the head dropped;
- the inverse (``export_aum_state_dict``, ``save_reference_checkpoint``):
  this package's weights as a ``.pth`` the reference (and the pretrain path
  above) loads.

``merge_with_init`` is the reference's ``load_state_dict(strict=False)``:
a key the ported dict lacks (a fresh head) comes from the model's init, an
extra key is ignored, a shape mismatch raises.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from aum_tpu_torch.models.tokenization import (
    patch_grid_shape,
    resample_abs_pos_embed,
    resample_patch_embed,
    to_2tuple,
)

_MIXER_KEYS = ("in_proj.weight", "conv1d.weight", "conv1d.bias", "x_proj.weight",
               "dt_proj.weight", "dt_proj.bias", "A_log", "D", "out_proj.weight")
_MIXER_KEYS_BI = {"none": (), "v1": ("A_b_log",),
                  "v2": ("A_b_log", "conv1d_b.weight", "conv1d_b.bias", "x_proj_b.weight",
                         "dt_proj_b.weight", "dt_proj_b.bias", "D_b")}


def _f32(v) -> torch.Tensor:
    """A checkpoint value (tensor or numpy array) as a CPU fp32 tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, np.float32))


def load_torch_checkpoint(path: str, modelkey: str | None = None) -> Dict:
    """A ``.pth`` file's state dict (CPU tensors), from under ``modelkey``
    when the file holds it. The file is unpickled in full
    (``weights_only=False``, as the reference's files need): load only
    checkpoints from a trusted source."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if modelkey is not None and modelkey in sd:
        sd = sd[modelkey]
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}


def _strip_module(sd: Dict) -> Dict:
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def infer_pretrain_grid(pos_embed, patch_size: Tuple[int, int], strides: Tuple[int, int],
                        num_prefix: int) -> Tuple[int, int]:
    """The (F', T') with F'*T' the pos embed's patch tokens, found by
    scanning audio lengths 2^6..2^19 at 128 mel bins."""
    n = pos_embed.shape[1] - num_prefix
    for log_len in range(6, 20):
        grid = patch_grid_shape(strides, patch_size, 128, 2 ** log_len)
        if grid[0] * grid[1] == n:
            return grid
    raise ValueError(f"could not infer pretrain grid for {n} patch tokens")


def _insert_to_prefix(pos: torch.Tensor, from_pos: int | Sequence[int]) -> torch.Tensor:
    """Move the pos-embed slot(s) ``from_pos`` to the front, in order (the
    reference's ``FlexiPosEmbed.insert_to_prefix``)."""
    if isinstance(from_pos, int):
        from_pos = [from_pos]
    x = pos
    for i, fp in enumerate(from_pos):
        x = torch.cat([x[:, :i], x[:, fp:fp + 1], x[:, i:fp], x[:, fp + 1:]], dim=1)
    return x


def _port_body(sd: Dict, cfg, pos: torch.Tensor, kernel: torch.Tensor,
               cls_if_present: bool) -> Dict[str, torch.Tensor]:
    """The keys the model takes from a checkpoint whose pos embed and patch
    kernel already fit ``cfg``: patch embed, pos embed, final norm, cls
    token(s), and each layer's norm and mixer."""
    out = {"patch_embed.proj.weight": kernel,
           "patch_embed.proj.bias": _f32(sd["patch_embed.proj.bias"]),
           "pos_embed.pos_embed": pos,
           "norm_f.weight": _f32(sd["norm_f.weight"])}
    if cfg.if_cls_token:
        names = ("cls_token_head", "cls_token_tail") if cfg.use_double_cls_token else (
            "cls_token",)
        for name in names:
            if not cls_if_present or name in sd:
                out[name] = _f32(sd[name])
    mixer = _MIXER_KEYS + _MIXER_KEYS_BI[cfg.bimamba_type]
    for i in range(cfg.depth):
        out[f"layers.{i}.norm.weight"] = _f32(sd[f"layers.{i}.norm.weight"])
        pre = f"layers.{i}.mixer."
        for k in mixer + (("gamma",) if pre + "gamma" in sd else ()):
            out[pre + k] = _f32(sd[pre + k])
    return out


def port_aum_state_dict(sd: Dict, cfg, pretrain_fstride: int | None = None,
                        pretrain_tstride: int | None = None) -> Dict[str, torch.Tensor]:
    """A reference AuM checkpoint -> the state dict of ``AudioMamba(cfg)``:
    the patch kernel PI-resized if its patch size differs, the pos embed
    resampled to cfg's grid (the pretrain grid inferred at the pretrain
    strides, which default to the checkpoint's patch size), the head kept
    only when its class count is cfg's. Keys the result lacks come from an
    init (``merge_with_init``)."""
    sd = _strip_module(sd)
    proj_w = _f32(sd["patch_embed.proj.weight"])  # (D, 1, ph, pw)
    patch_size_load = tuple(proj_w.shape[-2:])
    strides_load = (pretrain_fstride if pretrain_fstride is not None else patch_size_load[0],
                    pretrain_tstride if pretrain_tstride is not None else patch_size_load[1])
    pos = _f32(sd["pos_embed.pos_embed"])
    if pos.shape[1] == cfg.num_prefix_tokens + cfg.num_patches:
        grid_load = tuple(cfg.patch_grid)  # no resample: no grid inference either
    else:
        grid_load = infer_pretrain_grid(pos, patch_size_load, strides_load,
                                        cfg.num_prefix_tokens)
    if to_2tuple(cfg.patch_size) != patch_size_load:
        proj_w = resample_patch_embed(proj_w, to_2tuple(cfg.patch_size))
    if tuple(cfg.patch_grid) != grid_load:
        pos = resample_abs_pos_embed(pos, cfg.patch_grid, grid_load, cfg.num_prefix_tokens)
    out = _port_body(sd, cfg, pos, proj_w, cls_if_present=False)
    if "head.weight" in sd and sd["head.weight"].shape[0] == cfg.num_classes:
        out["head.weight"] = _f32(sd["head.weight"])
        out["head.bias"] = _f32(sd["head.bias"])
    return out


def port_vim_imagenet_state_dict(sd: Dict, cfg, load_middle_cls_token: bool = True,
                                 load_double_cls_token: bool = False
                                 ) -> Dict[str, torch.Tensor]:
    """An ImageNet ViM checkpoint -> the state dict of ``AudioMamba(cfg)``:
    the cls pos embed, stored at its sequence position (the middle, or both
    ends for the double cls), moved to the prefix slot(s); the (square) grid
    resampled to cfg's; the RGB patch kernel averaged to one channel; the
    head dropped."""
    sd = _strip_module(sd)
    pos = _f32(sd["pos_embed"])
    if load_double_cls_token:
        pos = _insert_to_prefix(pos, [0, pos.shape[1] - 1])
    elif load_middle_cls_token:
        pos = _insert_to_prefix(pos, (pos.shape[1] - 1) // 2)
    side = int(round((pos.shape[1] - cfg.num_prefix_tokens) ** 0.5))
    if tuple(cfg.patch_grid) != (side, side):
        pos = resample_abs_pos_embed(pos, cfg.patch_grid, (side, side), cfg.num_prefix_tokens)
    # The pos embed now fits cfg's grid: no audio-grid inference may run on
    # it (a token count that some 128-bin grid also has would resample it a
    # second time, from the wrong grid).
    expected = cfg.num_prefix_tokens + cfg.num_patches
    if pos.shape[1] != expected:
        raise ValueError(f"pos embed has {pos.shape[1]} tokens, expected {expected}")
    kernel = _f32(sd["patch_embed.proj.weight"]).mean(dim=1, keepdim=True)
    return _port_body(sd, cfg, pos, kernel, cls_if_present=True)


def export_aum_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """An AudioMamba's weights as the reference's state dict: CPU fp32
    copies. The module tree already is the reference's layout, so the result
    strict-loads into the reference model of the same constructor
    arguments (the JAX function also takes the config, to unstack layers)."""
    return {k: _f32(v).clone() for k, v in model.state_dict().items()}


def save_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """``torch.save`` the exported state dict: a ``.pth`` that the
    reference's AuM pretrain load (and ``run.py``'s ``aum_pretrain_path``)
    reads."""
    torch.save(export_aum_state_dict(model), path)


def merge_with_init(ported: Dict, init: Dict) -> Dict:
    """``init`` (a model's ``state_dict()``) with the ``ported`` values in
    its dtypes: a key ``ported`` lacks keeps its init, a key ``init`` lacks
    is ignored, a shape mismatch raises ``ValueError``."""
    out = {}
    for k, v in init.items():
        if k in ported:
            new = _f32(ported[k])
            if tuple(new.shape) != tuple(v.shape):
                raise ValueError(f"{k}: checkpoint shape {tuple(new.shape)}, model "
                                 f"shape {tuple(v.shape)}")
            out[k] = new.to(v.dtype)
        else:
            out[k] = v
    return out
