"""Eval: tagging a clip collection, one client in a closed loop.

Each call copies the next batch of the pool from pinned host memory to the
card, runs the port's ``make_eval_step`` on the model and brings its logits
back to the host. The check samples ``check_rows`` rows, drawn from the
seed, of the logits the window brought back, and compares each with the
reference's fp32 logits of the same log-mel row.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import aum, harness, traffic

WARMUP_CALLS = 2


class Session:
    def __init__(self, cell: dict, seed: int, device):
        from aum_tpu_torch.train import make_eval_step

        cfg, tr = cell["config_spec"], cell["traffic_spec"]
        self.device = device
        self.pool = traffic.make_pool(tr, cfg, seed, device)
        harness.log("pool drawn")
        self.model, self.param_shapes = aum.build_program(cfg, seed, device)
        harness.log("model built")
        self.step = make_eval_step(self.model)
        harness.settle(device)
        self.outputs = []
        for _ in range(WARMUP_CALLS):
            self.call()
        self.outputs = []

    def call(self):
        k = len(self.outputs) % self.pool.shape[0]
        x = self.pool[k].to(self.device, non_blocking=True)
        logits = self.step(x).cpu()
        self.outputs.append((k, logits))
        return logits.shape[0]

    def finish(self):
        out = {"pool": self.pool, "outputs": self.outputs, "param_shapes": self.param_shapes}
        failed = sum(not bool(torch.isfinite(logits).all()) for _, logits in self.outputs)
        del self.model, self.step
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out, failed


def setup(cell: dict, seed: int, device) -> Session:
    return Session(cell, seed, device)


def sample(cell: dict, seed: int, outputs: list):
    """(pool index, row) pairs and the program's logits of them, drawn from
    the seed among the window's calls."""
    tr = cell["traffic_spec"]
    rng = np.random.default_rng(seed)
    n = min(tr["check_rows"], len(outputs) * tr["batch"])
    picks = sorted(rng.choice(len(outputs) * tr["batch"], size=n, replace=False).tolist())
    rows = [(outputs[j // tr["batch"]][0], j % tr["batch"]) for j in picks]
    got = torch.stack([outputs[j // tr["batch"]][1][j % tr["batch"]] for j in picks])
    return rows, got


def reference(cell: dict, seed: int, pool, rows, param_shapes, device,
              precision: str = "fp32") -> torch.Tensor:
    cfg = cell["config_spec"]
    params = aum.seeded_params(cfg, param_shapes, seed, device)
    x = torch.stack([pool[k, r] for k, r in rows]).to(device)
    return aum.reference_logits(cfg, params, x, precision).cpu()


def checks(reference):
    """The check and the control of a driver whose calls return rows of
    logits, from its ``reference(cell, seed, pool, rows, param_shapes,
    device, precision)``."""

    def check(cell: dict, seed: int, out: dict, device) -> dict:
        rows, got = sample(cell, seed, out["outputs"])
        want = reference(cell, seed, out["pool"], rows, out["param_shapes"], device)
        return {"logit_rel_err": aum.row_rel_err(got, want)}

    def control(cell: dict, seed: int, out: dict, device) -> dict:
        """The control's reading: the reference in fp8 in the program's place."""
        rows, _ = sample(cell, seed, out["outputs"])
        args = (cell, seed, out["pool"], rows, out["param_shapes"], device)
        return {"fp8": {"logit_rel_err": aum.row_rel_err(reference(*args, precision="fp8"),
                                                         reference(*args))}}

    return check, control


check, control = checks(reference)


def end_to_end(stats: dict) -> dict:
    return {"eval_clips_per_s": (stats["clips"] / stats["window_s"], "clips/s"),
            "latency_p95_ms": (harness.percentile(stats["latencies"], 95) * 1e3, "ms")}
