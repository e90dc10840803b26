"""Checkpoint conversion.

- ``jax_params``: the JAX package's parameter trees -> this package's state
  dicts (``state_dict_from_jax``, ``lm_state_dict_from_jax``,
  ``ast_state_dict_from_jax``).
- ``torch_port``: reference AuM and ImageNet ViM ``.pth`` checkpoints ->
  ``AudioMamba`` state dicts, and back (``aum_tpu/convert/torch_port.py``'s
  counterpart).
- ``ast_port``: timm DeiT and reference AST checkpoints -> ``ASTModel``
  state dicts, and back (``aum_tpu/convert/ast_port.py``'s counterpart).
- ``ref_runner``: the upstream model code importable without its CUDA/Triton
  extensions, through torch oracles of its fused ops
  (``aum_tpu/convert/ref_runner.py``'s counterpart; imported by name, as it
  fills ``sys.modules``).
"""

from aum_tpu_torch.convert.ast_port import (
    export_ast_state_dict,
    port_ast_pretrain_state_dict,
    port_deit_state_dict,
)
from aum_tpu_torch.convert.jax_params import (
    ast_state_dict_from_jax,
    lm_state_dict_from_jax,
    state_dict_from_jax,
)
from aum_tpu_torch.convert.torch_port import (
    export_aum_state_dict,
    infer_pretrain_grid,
    load_torch_checkpoint,
    merge_with_init,
    port_aum_state_dict,
    port_vim_imagenet_state_dict,
    save_reference_checkpoint,
)

__all__ = [
    "ast_state_dict_from_jax",
    "export_ast_state_dict",
    "export_aum_state_dict",
    "infer_pretrain_grid",
    "lm_state_dict_from_jax",
    "load_torch_checkpoint",
    "merge_with_init",
    "port_ast_pretrain_state_dict",
    "port_aum_state_dict",
    "port_deit_state_dict",
    "port_vim_imagenet_state_dict",
    "save_reference_checkpoint",
    "state_dict_from_jax",
]
