"""Checkpoints: best and latest tracking, and weight averaging.

Counterpart of ``aum_tpu/train/checkpoints.py`` on ``torch.save``, with the
same layout under the directory:

- ``best`` and ``epoch_<n>``: one file each, holding the model's and the
  optimizer's state dicts and the train state's ``step``, ``loss_sum`` and
  ``nonfinite_count``;
- ``best.json`` and ``latest.json``: the epoch and its scalar metrics.

``average_params`` averages model state dicts uniformly, as the reference's
weight-averaging eval (``validate_wa``) does.
"""

from __future__ import annotations

import json
import os

import torch

from aum_tpu_torch.train.loop import TrainState


class Checkpointer:
    """Save and restore a ``TrainState`` with best and latest tracking."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _save(self, name: str, state: TrainState) -> None:
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "step": state.step, "loss_sum": state.loss_sum,
                   "nonfinite_count": state.nonfinite_count}
        tmp = self._path(f".{name}.tmp{os.getpid()}")
        torch.save(payload, tmp)
        os.replace(tmp, self._path(name))  # a reader never sees half a file

    def save_best(self, state: TrainState, epoch: int, metrics: dict) -> None:
        self._save("best", state)
        self._meta("best", epoch, metrics)

    def save_latest(self, state: TrainState, epoch: int, metrics: dict) -> None:
        self._save(f"epoch_{epoch}", state)
        self._meta("latest", epoch, metrics)

    def _meta(self, tag: str, epoch: int, metrics: dict) -> None:
        with open(self._path(f"{tag}.json"), "w") as f:
            json.dump({"epoch": epoch,
                       "metrics": {k: v for k, v in metrics.items()
                                   if isinstance(v, (int, float, str))}}, f)

    def load(self, name: str) -> dict:
        """The saved payload of ``name``, its tensors on the CPU."""
        return torch.load(self._path(name), map_location="cpu", weights_only=True)

    def model_state(self, name: str) -> dict:
        """The model state dict saved as ``name``, on the CPU."""
        return self.load(name)["model"]

    def restore(self, name: str, state: TrainState) -> TrainState:
        """Load checkpoint ``name`` into ``state``'s model and optimizer in
        place (onto their devices) and return the state with its counters."""
        payload = self.load(name)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.loss_sum = float(payload["loss_sum"])
        state.nonfinite_count = int(payload["nonfinite_count"])
        return state

    def available_epochs(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("epoch_"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)


def average_params(state_dicts: list[dict]) -> dict:
    """The uniform average of model state dicts (validate_wa: the sum of the
    state dicts over their count), each tensor in its own dtype."""
    if not state_dicts:
        raise ValueError("average_params needs at least one state dict")
    return {k: torch.stack([sd[k] for sd in state_dicts]).mean(dim=0)
            for k in state_dicts[0]}
