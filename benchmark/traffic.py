"""The general generator: input pools from a traffic file's parameters.

A traffic file (``traffic/<name>.json``) names its driver and gives the
batch, the number of distinct batches in the pool (``pool``), what a row
is (``input``: "logmel" rows of the configuration's spectrogram, or
"waveform" rows of ``clip_seconds`` at the configuration's sample rate),
the rows' level (``scale`` times N(0, 1)), whether the pool sits in pinned
host memory, and the check's sample. Every seed gives the same sizes; only
the values differ. The values are drawn on the card, one batch at a time,
and copied to the host.
"""

from __future__ import annotations

import torch


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each stream drawn from one run's seed."""
    return (seed * 1_000_003 + stream) % (2 ** 63)


def row_shape(traffic: dict, config: dict) -> tuple:
    if traffic["input"] == "logmel":
        f, t = config["model"]["spectrogram_size"]
        return (t, f)
    if traffic["input"] == "waveform":
        return (int(traffic["clip_seconds"] * config["frontend"]["sample_rate"]),)
    raise ValueError(f"unknown input {traffic['input']!r}")


def make_pool(traffic: dict, config: dict, seed: int, device) -> torch.Tensor:
    """(pool, batch, *row) fp32 on the host."""
    shape = (traffic["batch"],) + row_shape(traffic, config)
    out = torch.empty((traffic["pool"],) + shape, dtype=torch.float32,
                      pin_memory=bool(traffic.get("pinned")) and torch.cuda.is_available())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    for i in range(traffic["pool"]):
        batch = torch.randn(shape, generator=gen, device=device).mul_(traffic["scale"])
        out[i].copy_(batch)
    return out
