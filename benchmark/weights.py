"""Weights drawn from the seed on the device, by the configuration's rules.

One uniform draw in [-1, 1) covers every parameter, in one call on the
card's generator; each leaf is then a view of it, shaped by the first rule
(in the configuration's ``weights`` list) whose pattern matches its key:

- ``uniform``: ``bound * u``;
- ``one_plus``: ``1 + spread * u`` (norm weights, D);
- ``log_arange``: ``log(n + 1) + spread * u`` along the last axis (A_log);
- ``dt_bias``: the inverse softplus of a dt log-uniform in [lo, hi];
- ``zeros``.

The same seed gives the same tensors on the same device, so the reference
draws them again after the window instead of holding a copy.
"""

from __future__ import annotations

import math
import re

import torch


def _leaf(rule: dict, u: torch.Tensor) -> torch.Tensor:
    kind = rule["rule"]
    if kind == "uniform":
        return u * rule["bound"]
    if kind == "one_plus":
        return 1.0 + rule["spread"] * u
    if kind == "log_arange":
        n = torch.arange(1, u.shape[-1] + 1, dtype=torch.float32, device=u.device)
        return torch.log(n) + rule["spread"] * u
    if kind == "dt_bias":
        lo, hi = math.log(rule["lo"]), math.log(rule["hi"])
        dt = torch.exp(lo + (u + 1.0) * 0.5 * (hi - lo))
        return dt + torch.log(-torch.expm1(-dt))
    if kind == "zeros":
        return torch.zeros_like(u)
    raise ValueError(f"unknown weight rule {kind!r}")


def draw(shapes: dict, rules: list, seed: int, device) -> dict:
    """{key: fp32 tensor of shapes[key]} from ``seed``; every key must match
    a rule."""
    compiled = [(re.compile(r["match"]), r) for r in rules]
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes.values()), generator=gen, device=device).mul_(2).sub_(1)
    out, at = {}, 0
    for key, shape in shapes.items():
        rule = next((r for pat, r in compiled if pat.fullmatch(key)), None)
        if rule is None:
            raise KeyError(f"no weight rule matches {key!r}")
        out[key] = _leaf(rule, flat[at:at + sizes[key]].view(shape)).contiguous()
        at += sizes[key]
    return out
