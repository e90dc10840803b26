"""Logging helpers.

Counterpart of ``aum_tpu/logging_utils.py``, which follows the reference's
EPIC logging module: logging only on the primary process, print suppression
elsewhere, a ``stdout.log`` file handler and json-serialized stat lines. The
rank is ``torch.distributed``'s when a process group is up, else 0.
"""

from __future__ import annotations

import builtins
import json
import logging
import os
import sys

import torch


def is_master_proc() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def suppress_print() -> None:
    """Swallow print() on non-master processes."""

    def print_none(*objects, sep=" ", end="\n", file=sys.stdout, flush=False):
        pass

    builtins.print = print_none


def setup_logging(output_dir: str | None = None,
                  name: str = "aum_tpu_torch") -> logging.Logger:
    """Master-only logger with an optional stdout.log file."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(
        "[%(asctime)s][%(levelname)s] %(filename)s: %(lineno)3d: %(message)s",
        datefmt="%m/%d %H:%M:%S")
    if is_master_proc():
        sh = logging.StreamHandler(stream=sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(output_dir, "stdout.log"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        suppress_print()
        logger.addHandler(logging.NullHandler())
    return logger


def log_json_stats(stats: dict, logger: logging.Logger | None = None) -> None:
    """One json line of stats, floats rounded to 5 places."""
    rounded = {k: round(v, 5) if isinstance(v, float) else v
               for k, v in stats.items()}
    line = json.dumps(rounded, sort_keys=True, default=str)
    (logger or logging.getLogger("aum_tpu_torch")).info("json_stats: %s", line)
