"""Spawn the ranks of a parallel run and collect what each returns.

``spawn(target, world, kwargs, backend=)`` starts ``world`` processes with
the ``spawn`` start method (CUDA cannot be used in a forked child), on the
CUDA card unless ``device`` names another device, each of which starts
``torch.distributed`` with the backend the caller names through a ``FileStore``
in a fresh temporary directory (so runs on one host never share a
rendezvous), calls ``target`` (``"module:function"``, imported by module
path) with ``kwargs``, and sends back its return value. On the CPU each rank
runs one thread. On the card the kernel libraries must be built in the
parent before the spawn: a rank only loads them and raises if one is
missing, so that ranks never race each other's builds.

The per-rank bodies of the checks (``parallel/checks.py``) run this way:
``entry.dryrun_multichip``, the CPU tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import tempfile
import traceback

import torch
import torch.distributed as dist

from aum_tpu_torch.utils import resolve_device

DEFAULT_TIMEOUT = 900.0


def resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def _child(target: str, rank: int, world: int, store: str, backend: str, device: str,
           kwargs: dict, out_dir: str) -> None:
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world))
        from aum_tpu_torch.ops import _build
        from aum_tpu_torch.parallel.multihost import check_backend

        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        else:
            _build.PREBUILT_ONLY = True
            torch.cuda.set_device(torch.device(device))
        check_backend(backend, world)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=600))
        try:
            result = resolve(target)(**kwargs)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    """Ranks started by ``start``; ``join`` waits for them and returns their
    results, so the caller can work meanwhile."""

    def __init__(self, target: str, world: int, kwargs: dict, backend: str, device: str,
                 timeout: float):
        self.target, self.world, self.timeout = target, world, timeout
        self._tmp = tempfile.TemporaryDirectory()
        tmp = self._tmp.name
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_child, args=(target, r, world,
                                                       os.path.join(tmp, "store"), backend,
                                                       device, kwargs, tmp), daemon=True)
                      for r in range(world)]
        self.started = datetime.datetime.now()
        for p in self.procs:
            p.start()

    def join(self) -> list:
        """The ranks' results in rank order. Raises with a rank's traceback
        if any rank fails, and kills every rank left when one fails or the
        timeout passes."""
        procs, tmp = self.procs, self._tmp.name
        deadline = self.started + datetime.timedelta(seconds=self.timeout)
        try:
            try:
                while any(p.is_alive() for p in procs):
                    if any(p.exitcode not in (None, 0) for p in procs):
                        break
                    if datetime.datetime.now() > deadline:
                        break
                    for p in procs:
                        p.join(0.05)
            finally:
                for p in procs:
                    if p.is_alive():
                        p.kill()
                    p.join(5)
            errors = []
            for r, p in enumerate(procs):
                err = os.path.join(tmp, f"{r}.err")
                if os.path.exists(err):
                    with open(err) as f:
                        errors.append(f"rank {r}:\n{f.read()}")
                elif p.exitcode != 0:
                    errors.append(f"rank {r}: exit code {p.exitcode}"
                                  + (" (killed: another rank failed, or the timeout)"
                                     if p.exitcode is not None and p.exitcode < 0 else ""))
            if errors:
                raise RuntimeError(f"{self.target} failed on {len(errors)} of {self.world} "
                                   "rank(s):\n" + "\n".join(errors))
            return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
                    for r in range(self.world)]
        finally:
            self._tmp.cleanup()


def start(target: str, world: int, kwargs: dict | None = None, *, backend: str,
          device: str | torch.device | None = None, timeout: float = DEFAULT_TIMEOUT) -> Ranks:
    """Start ``target(**kwargs)`` on ``world`` new ranks of one process
    group over ``backend``; ``.join()`` returns their results. ``device`` is
    where each rank runs: the CUDA card unless the caller names another
    device (raises without a card); every rank shares that card, which
    needs ``backend="gloo"`` for more than one rank."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Ranks(target, world, kwargs or {}, backend, str(device), timeout)


def spawn(target: str, world: int, kwargs: dict | None = None, *, backend: str,
          device: str | torch.device | None = None, timeout: float = DEFAULT_TIMEOUT) -> list:
    """``start(...).join()``: the ranks' results in rank order."""
    return start(target, world, kwargs, backend=backend, device=device, timeout=timeout).join()
