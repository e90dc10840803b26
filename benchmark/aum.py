"""AuM cells: the port's model built from a configuration file and the seed's
weights, and the reference run on the same weights and inputs.

The port is reached only through its public entry points:
``aum_tpu_torch.models.AudioMamba`` / ``AudioMambaConfig``, ``load_state_dict``,
``aum_tpu_torch.train`` (``make_eval_step``, ``make_train_step``,
``make_optimizer``, ``init_train_state``, ``TrainHyperParams``) and
``aum_tpu_torch.serving`` (``export_bundle``, ``load_bundle``,
``ServingModel.predict``).
"""

from __future__ import annotations

import torch

from benchmark import weights
from benchmark.reference import aum as ref_aum
from benchmark.reference.precision import rounding, set_exact_fp32


def seeded_params(config: dict, param_shapes: dict, seed: int, device) -> dict:
    return weights.draw(param_shapes, config["weights"], seed, device)


def build_program(config: dict, seed: int, device):
    """The port's AudioMamba of ``config`` holding the seed's weights, and
    the parameters' shapes by key."""
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    cfg = AudioMambaConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in config["model"].items()})
    model = AudioMamba(cfg, device=device)
    param_shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(seeded_params(config, param_shapes, seed, device))
    return model, param_shapes


def reference_logits(config: dict, params: dict, x: torch.Tensor, precision: str = "fp32",
                     block: int = 16) -> torch.Tensor:
    """The reference's fp32 logits of log-mel rows ``x`` (on the params'
    device), in blocks of ``block`` rows."""
    set_exact_fp32()
    rnd = rounding(precision)
    with torch.no_grad():
        return torch.cat([ref_aum.logits(params, config["model"], x[i:i + block], rnd)
                          for i in range(0, x.shape[0], block)])


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest over rows of |got - want| / |want| (L2 norms of a row);
    inf where got is not finite."""
    got, want = got.double(), want.double()
    if not torch.isfinite(got).all():
        return float("inf")
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
