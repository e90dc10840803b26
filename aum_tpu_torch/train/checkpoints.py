"""Checkpoints: best and latest tracking, and weight averaging.

Counterpart of ``aum_tpu/train/checkpoints.py`` on ``torch.save``, with the
same layout under the directory:

- ``best`` and ``epoch_<n>``: one file each, holding the model's and the
  optimizer's state dicts and the train state's ``step``, ``loss_sum`` and
  ``nonfinite_count``;
- ``best.json`` and ``latest.json``: the epoch and its scalar metrics.

A checkpoint always holds the one-card layout. On a mesh (``Checkpointer(
..., mesh=)``) the model's and Adam's tensors are gathered into it on rank 0
alone (``parallel/mesh.py::gather_named``), rank 0 writes, and a restore
slices the one-card state for each rank again; so a checkpoint of a
parallel run restores into a one-card run, and the other way round.

``average_params`` averages model state dicts uniformly, as the reference's
weight-averaging eval (``validate_wa``) does.
"""

from __future__ import annotations

import json
import os

import torch

from aum_tpu_torch.train.loop import TrainState


def _distributed(mesh) -> bool:
    return mesh is not None and mesh.distributed


def gather_optimizer_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                           mesh, root_only: bool = False) -> dict | None:
    """The optimizer's state dict in the one-card layout (its state keyed by
    the one-card model's parameter order), on every rank, or with
    ``root_only`` on rank 0 alone (None elsewhere; see ``gather_named``)."""
    from aum_tpu_torch.parallel.mesh import full_param_names, gather_named

    sd = optimizer.state_dict()
    local = [k for k, _ in model.named_parameters()]
    names = full_param_names(model)
    by_name = {local[i]: st for i, st in sd["state"].items()}
    groups = [{**g, "params": list(range(len(names)))} for g in sd["param_groups"]]
    if not by_name:
        return {"state": {}, "param_groups": groups}
    any_state = next(iter(by_name.values()))
    moments = {key: gather_named(model, {k: st[key] for k, st in by_name.items()}, mesh, names,
                                 root_only)
               for key in ("exp_avg", "exp_avg_sq")}
    if root_only and mesh.rank != 0:
        return None
    state = {i: {"step": any_state["step"].clone(), "exp_avg": moments["exp_avg"][k],
                 "exp_avg_sq": moments["exp_avg_sq"][k]} for i, k in enumerate(names)}
    return {"state": state, "param_groups": groups}


def shard_optimizer_state(full: dict, model: torch.nn.Module) -> dict:
    """A one-card optimizer state dict sliced for this rank's ``model``."""
    from aum_tpu_torch.parallel.mesh import full_param_names, shard_state_dict

    names = full_param_names(model)
    local = [k for k, _ in model.named_parameters()]
    by_name = {names[i]: st for i, st in full["state"].items()}
    state = {}
    for j, k in enumerate(local):
        if k in by_name:
            st = by_name[k]
            cut = {key: shard_state_dict({k: st[key]}, model.mesh)[k]
                   for key in ("exp_avg", "exp_avg_sq")}
            state[j] = {"step": st["step"], **cut}
    groups = [{**g, "params": list(range(len(local)))} for g in full["param_groups"]]
    return {"state": state, "param_groups": groups}


class Checkpointer:
    """Save and restore a ``TrainState`` with best and latest tracking; on a
    mesh, a collective of every rank (rank 0 writes)."""

    def __init__(self, directory: str, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        self.writer = not _distributed(mesh) or mesh.rank == 0
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _save(self, name: str, state: TrainState) -> None:
        if _distributed(self.mesh):
            from aum_tpu_torch.parallel.mesh import gather_state_dict

            model_sd = gather_state_dict(state.model, self.mesh, root_only=True)
            opt_sd = gather_optimizer_state(state.model, state.optimizer, self.mesh,
                                            root_only=True)
        else:
            model_sd, opt_sd = state.model.state_dict(), state.optimizer.state_dict()
        if self.writer:
            payload = {"model": model_sd, "optimizer": opt_sd,
                       "step": state.step, "loss_sum": state.loss_sum,
                       "nonfinite_count": state.nonfinite_count}
            tmp = self._path(f".{name}.tmp{os.getpid()}")
            torch.save(payload, tmp)
            os.replace(tmp, self._path(name))  # a reader never sees half a file
        self._barrier()

    def _barrier(self) -> None:
        if _distributed(self.mesh):
            import torch.distributed as dist

            dist.barrier()

    def save_best(self, state: TrainState, epoch: int, metrics: dict) -> None:
        self._save("best", state)
        self._meta("best", epoch, metrics)

    def save_latest(self, state: TrainState, epoch: int, metrics: dict) -> None:
        self._save(f"epoch_{epoch}", state)
        self._meta("latest", epoch, metrics)

    def _meta(self, tag: str, epoch: int, metrics: dict) -> None:
        if not self.writer:
            return
        with open(self._path(f"{tag}.json"), "w") as f:
            json.dump({"epoch": epoch,
                       "metrics": {k: v for k, v in metrics.items()
                                   if isinstance(v, (int, float, str))}}, f)

    def load(self, name: str) -> dict:
        """The saved payload of ``name``, its tensors on the CPU."""
        return torch.load(self._path(name), map_location="cpu", weights_only=True)

    def model_state(self, name: str) -> dict:
        """The model state dict saved as ``name``, on the CPU (one-card layout)."""
        return self.load(name)["model"]

    def restore(self, name: str, state: TrainState) -> TrainState:
        """Load checkpoint ``name`` into ``state``'s model and optimizer in
        place (onto their devices; sliced for this rank on a mesh) and
        return the state with its counters."""
        from aum_tpu_torch.parallel.mesh import load_full_state_dict

        payload = self.load(name)
        load_full_state_dict(state.model, payload["model"])
        opt = payload["optimizer"]
        if getattr(state.model, "mesh", None) is not None:
            opt = shard_optimizer_state(opt, state.model)
        state.optimizer.load_state_dict(opt)
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
