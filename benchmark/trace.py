"""A traced stretch of the window: torch.profiler over a few calls, read into
device intervals, host ops, and the numbers every per-layer metric reads.

The profiler's Chrome trace of the stretch (tens of MB) is written under
``TMPDIR``, parsed and deleted. ``View`` gives the metric readers:

- ``kernels``: (name, start_us, dur_us) of every device kernel;
- ``device_ops``: kernels, copies and sets, the intervals that make the
  device busy;
- ``busy_s`` (the union of the device intervals) and ``window_s`` (the
  stretch's host time, from before its first call to after its last,
  both ends synchronized);
- ``calls`` and ``clips`` done in the stretch, and the cell;
- ``matching(group)``: the kernels whose name matches a pattern of that
  group's files under ``metrics/kernels/<group>/``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# The longest gaps between device intervals that ``breakdown`` labels.
LABELLED_GAPS = 500
KERNELS_DIR = Path(__file__).resolve().parent / "metrics" / "kernels"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def kernel_patterns(group: str, root: Path = KERNELS_DIR) -> list:
    """The regular expressions of every file in ``root/group``, one a line
    (blank lines and '#' comments skipped)."""
    pats = []
    for path in sorted((root / group).glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                pats.append(re.compile(line))
    if not pats:
        raise FileNotFoundError(f"no kernel patterns under {root / group}")
    return pats


def short_name(name: str) -> str:
    """A kernel's name without its namespace prefix and argument list, at
    most 160 characters."""
    return name.replace("(anonymous namespace)::", "").split("(")[0][:160]


@dataclasses.dataclass
class View:
    kernels: list
    device_ops: list
    host_ops: list
    window_s: float
    calls: int
    clips: int
    cell: dict
    kernels_root: Path = KERNELS_DIR

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _union(self.device_ops)) / 1e6

    def summary(self) -> str:
        """The stretch's seconds, its busy seconds, its largest gap between
        device intervals, and the first and last device op's times from its
        two ends (the host's clock and the trace's lie within microseconds)."""
        spans = _union(self.device_ops)
        if not spans:
            return f"window {self.window_s:.4f} s, no device op"
        gap = max((b[0] - a[1] for a, b in zip(spans, spans[1:])), default=0.0) / 1e6
        lead = self.window_s - (spans[-1][1] - spans[0][0]) / 1e6
        return (f"window {self.window_s:.4f} s, busy {self.busy_s:.4f} s, largest gap "
                f"{gap:.4f} s, outside the device ops {lead:.4f} s")

    def matching(self, group: str) -> list:
        pats = kernel_patterns(group, self.kernels_root)
        return [k for k in self.kernels if any(p.search(k[0]) for p in pats)]


def _union(ops) -> list:
    spans = sorted((s, s + d) for _, s, d in ops)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Stretch:
    """Profiles the calls between ``start()`` and ``stop()``: the device's
    activity alone, or with ``host_ops`` the host's ops as well (which slows
    the host down, so only the breakdown's gap labels read such a
    stretch)."""

    def __init__(self, host_ops: bool = False):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if host_ops or not torch.cuda.is_available() else []
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        _sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        _sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def view(self, calls: int, clips: int, cell: dict) -> View:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            row = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
            if e.get("cat") in DEVICE_CATS:
                dev.append((e.get("cat"), row))
            elif e.get("cat") in HOST_CATS:
                host.append(row)
        kernels = [r for c, r in dev if c == "kernel"]
        return View(kernels=kernels, device_ops=[r for _, r in dev], host_ops=host,
                    window_s=self.t1 - self.t0, calls=calls, clips=clips, cell=cell)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def top_device_ops(view: View, top: int = 10) -> list:
    """The device ops that took most time, by name: [name, seconds]."""
    by_name = {}
    for name, _, dur in view.device_ops:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + dur / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(view: View, top: int = 10) -> list:
    """The idle time of the ``LABELLED_GAPS`` longest gaps between device
    intervals, summed by the host op running at each gap's middle (the
    innermost one): [label, seconds]."""
    spans = _union(view.device_ops)
    between = sorted(((s1 - e0, 0.5 * (e0 + s1)) for (_, e0), (s1, _) in zip(spans, spans[1:])),
                     reverse=True)[:LABELLED_GAPS]
    names = [h[0] for h in view.host_ops]
    starts = np.array([h[1] for h in view.host_ops])
    ends = starts + np.array([h[2] for h in view.host_ops])
    gaps = {}
    for length, mid in between:
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        label = (names[inside[np.argmin(ends[inside] - starts[inside])]] if inside.size
                 else "no host op")
        gaps[label] = gaps.get(label, 0.0) + length / 1e6
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]
