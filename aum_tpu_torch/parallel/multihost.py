"""Multi-process execution: starting the process group, and the host gathers.

Counterpart of ``aum_tpu/parallel/multihost.py``. JAX runs one controller
per host over a global device mesh; the port runs one process per rank, as
the reference's ``accelerate launch`` does, under ``torchrun`` (its
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) or an explicit coordinator address.

- ``maybe_initialize_distributed`` starts ``torch.distributed``: ``"auto"``
  when torchrun's environment (``WORLD_SIZE`` > 1 and ``MASTER_ADDR``) or a
  coordinator is present, ``"on"`` always, ``"off"`` never. The backend is
  NCCL when every rank has a card of its own and gloo on the CPU; ranks that
  share one card must name gloo (``backend="gloo"``): it is never picked
  silently, and NCCL asked for with more ranks on a node than cards raises.
- ``globalize_batches`` is a passthrough: each rank's pipeline already
  yields its own slice of the global batch, and the train step averages the
  grads over the 'data' group.
- ``to_host_global`` brings a tensor whose rows are split over the 'data'
  group to every rank, whole, as numpy (the metrics' gather).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from aum_tpu_torch.parallel import collectives

BACKENDS = ("nccl", "gloo")
TIMEOUT = datetime.timedelta(minutes=30)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: ``cuda:<local rank mod cards>`` for a CUDA
    ``device`` without an index, else ``device``."""
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def check_backend(backend: str, local_world: int) -> None:
    """Raise for an unknown backend, and for NCCL with more ranks on this
    node than cards (NCCL refuses two ranks on one card)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_world > cards:
            raise ValueError(
                f"NCCL needs a card per rank: {local_world} rank(s) on this node share "
                f"{cards} card(s); name backend='gloo' for ranks that share a card")


def maybe_initialize_distributed(
    mode: str = "auto",
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[torch.device] = None,
) -> bool:
    """Start ``torch.distributed`` when a multi-process run is asked for.

    ``mode``: "on" always; "auto" when torchrun's environment or a
    coordinator is present; "off" never. ``coordinator_address`` is
    ``host:port`` of rank 0 (``tcp://`` rendezvous), with ``num_processes``
    and ``process_id``; else torchrun's ``env://``. ``backend``: None picks
    NCCL for a CUDA ``device`` (the default) and gloo for a CPU one.
    Returns True when the group is (or already was) started.
    """
    if dist.is_initialized():
        return True
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown multihost mode {mode!r}")
    if mode == "off":
        return False
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if mode == "auto" and not (coordinator_address
                               or (env_world > 1 and os.environ.get("MASTER_ADDR"))):
        return False
    world = num_processes if num_processes is not None else env_world
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if backend is None:
        on_cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if on_cpu else "nccl"
    check_backend(backend, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if coordinator_address:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank, timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank,
                                timeout=TIMEOUT)
    return True


def globalize_batches(it, mesh=None):
    """Each rank's batches as they are: the pipelines already slice the data
    by the 'data' coordinate."""
    yield from it


def to_host_global(x: torch.Tensor, mesh=None) -> np.ndarray:
    """The whole of ``x``, split by rows over the 'data' group as the
    pipelines split the order (``order[r::n]``), on every rank, as numpy."""
    if mesh is not None and mesh.distributed:
        x = collectives.gather_rows(x, mesh.group("data"), tag="eval_gather")
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
