"""The harness: finds a cell's files by name, runs its driver's set-up and
window, reads the traced stretch, checks the outputs, and assembles the
result line.

Files, each found by the name ``BENCHMARK.json`` gives:

- ``workloads/<cell>.json``: the configuration, the traffic, the chips, the
  check's limits and the cell's ``why``;
- ``configs/<config>.json``: the sizes as run, the source, the weights'
  rules and the deployment;
- ``traffic/<traffic>.json``: the driver that runs it and its parameters;
- ``drivers/<driver>.py``: ``setup(cell, seed, device) -> session`` with
  ``session.call() -> clips`` and ``session.finish() -> (outputs, calls
  whose outputs are not finite)``,
  ``check(cell, seed, outputs, device) -> {number: value}``, and
  ``end_to_end(stats) -> {metric: (value, unit)}``;
- ``metrics/<metric>.py``: one per-layer metric, with the cells that
  report it and ``read(view) -> value or None``.

A driver's session warms up every shape it will use inside ``setup``; the
window then runs calls until ``seconds`` have passed, and its time runs to
the end of the last call, so a rate is all the work over all the time. A
call does no host-side tensor work of the benchmark's own: the outputs are
checked for finite values after the window (a check on the host inside it
woke torch's CPU thread pool and stalled calls by up to 40 ms).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from benchmark import trace as tracing

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aum_tpu")
# The traced stretches start at this call of the window.
TRACE_FIRST_CALL = 2


def load(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} file {path}")
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> dict:
    cell = load("workloads", name, root)
    cell["name"] = name
    cell["config_spec"] = load("configs", cell["config"], root)
    cell["traffic_spec"] = load("traffic", cell["traffic"], root)
    return cell


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT):
    return load_module(root / "drivers" / f"{name}.py")


def metrics_of(cell_name: str, root: Path = ROOT) -> list:
    """The per-layer metric modules that list ``cell_name``."""
    mods = [load_module(p) for p in sorted((root / "metrics").glob("*.py"))]
    return [m for m in mods if cell_name in m.WORKLOADS]


def forbidden_modules(names) -> list:
    """The names whose top-level package (before the first dot) is one the
    run may not load."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def settle(device: torch.device) -> None:
    """Free what set-up drew for the benchmark itself and start the memory
    peak there, with the program's state in place."""
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def log(message: str) -> None:
    """A line on standard error, stamped with the wall clock."""
    now = time.time()
    stamp = time.strftime("%H:%M:%S", time.localtime(now)) + f".{int(now % 1 * 1000):03d}"
    print(f"[{stamp}] {message}", file=sys.stderr, flush=True)


def run(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
        process_start: float, root: Path = ROOT) -> dict:
    """One run of ``cell``: the result line's object, ``check`` last.

    A traced run profiles two stretches of ``trace_calls`` calls each from
    the window's call ``TRACE_FIRST_CALL``: the device alone, which every
    per-layer metric and the device ops read, then the device with the
    host's ops, which labels the idle gaps. It goes on until both are done."""
    drv = driver(cell["traffic_spec"]["driver"], root)
    session = drv.setup(cell, seed, device)
    setup_s = time.time() - process_start
    log(f"set-up done: {setup_s:.2f} s")
    n = cell["traffic_spec"]["trace_calls"]
    # (stretch, its first call, its calls). The profiler's first session in
    # a process sets itself up, so one call under a session read by nothing
    # comes first.
    stretches = ([(tracing.Stretch(), TRACE_FIRST_CALL - 1, 1),
                  (tracing.Stretch(), TRACE_FIRST_CALL, n),
                  (tracing.Stretch(host_ops=True), TRACE_FIRST_CALL + n, n)] if trace else [])
    views, latencies, clips, traced_from = [], [], 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or stretches:
        if stretches and len(latencies) == stretches[0][1]:
            stretches[0][0].start()
            traced_from = clips
        ts = time.perf_counter()
        clips += session.call()
        latencies.append(time.perf_counter() - ts)
        if stretches and len(latencies) == stretches[0][1] + stretches[0][2]:
            stretch, _, calls = stretches.pop(0)
            stretch.stop()
            # Read before the next stretch starts: a new profiler session
            # clears the last one's events.
            views.append(stretch.view(calls, clips - traced_from, cell))
            log("stretch read: " + views[-1].summary())
    window_s = time.perf_counter() - t0
    qs = [percentile(latencies, q) * 1e3 for q in (0, 10, 50, 90, 99, 100)]
    log(f"window done: {len(latencies)} calls in {window_s:.2f} s; ms a call at "
        "0/10/50/90/99/100%: " + " ".join(f"{q:.2f}" for q in qs))
    info = device_info(device, cell["chips"])
    stats = {"clips": clips, "window_s": window_s, "latencies": latencies,
             "setup_s": setup_s, "memory_peak_bytes": info["memory_peak_bytes"]}
    outputs, failed = session.finish()
    del session
    numbers = drv.check(cell, seed, outputs, device)
    log("check done: " + ", ".join(f"{k} {v:.3e}" for k, v in numbers.items()))
    limits = cell["limits"]
    result = {"correct": failed == 0 and all(numbers[k] <= limits[k] for k in limits),
              "attempted": len(latencies), "failed": failed}
    if not trace:
        metrics = {"setup_s": (setup_s, "s"), **drv.end_to_end(stats)}
    else:
        _, view, with_host = views
        metrics = {}
        for m in metrics_of(cell["name"], root):
            value = m.read(view)
            if value is not None:
                metrics[m.NAME] = (value, m.UNIT)
        info.update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = {"device_ops": tracing.top_device_ops(view),
                               "idle_gaps": tracing.idle_gaps(with_host)}
        log("trace read")
    result["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()}
    result["device"] = info
    # A number that is not finite (outputs that are not) reads as the
    # largest double, so that the line stays JSON.
    result["check"] = {k: {"value": (numbers[k] if math.isfinite(numbers[k])
                                     else sys.float_info.max), "limit": limits[k]}
                       for k in limits}
    return result


def emit(result: dict) -> None:
    """Each number compared beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
