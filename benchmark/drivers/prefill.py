"""Prefill: one long document a request, one client in a closed loop.

Each call copies the next sequence of token ids of the pool from pinned
host memory to the card, runs the port's LM prefill
(``aum_tpu_torch.models.lm.prefill``: the whole prompt in one pass, the
hybrid cache built beside it) and brings the last position's logits back to
the host. The MoE layers' expert choices of every call stay on the card
(``JambaLM.record_routes``, 2 bytes a token a layer).

The check samples ``check_rows`` calls of the window, drawn from the seed,
and compares their logits with the reference's fp32 logits of the same
sequences (``reference/jamba.py``). The reference takes the program's expert
choices only at near-ties, gaps up to the workload's ``router_tie_margin``
of its own fp32 probabilities; positions beyond the margin are counted in
``routes_beyond_margin``, whose limit is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import harness, jamba
from benchmark.aum import row_rel_err
from benchmark.traffic import sub_seed

WARMUP_CALLS = 2


def make_ids_pool(traffic: dict, config: dict, seed: int, device) -> torch.Tensor:
    """(pool, batch, seqlen) int64 token ids, uniform over the vocabulary,
    drawn on the card and kept on the host (pinned where the traffic says)."""
    shape = (traffic["pool"], traffic["batch"], traffic["seqlen"])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    ids = torch.randint(0, config["vocab_size"], shape, generator=gen, device=device)
    pinned = bool(traffic.get("pinned")) and torch.cuda.is_available()
    return ids.cpu().pin_memory() if pinned else ids.cpu()


class Session:
    def __init__(self, cell: dict, seed: int, device):
        from aum_tpu_torch.models.lm import prefill

        cfg, tr = cell["config_spec"], cell["traffic_spec"]
        self.device, self.prefill = device, prefill
        self.pool = make_ids_pool(tr, cfg, seed, device)
        harness.log("pool drawn")
        self.model = jamba.build_program(cfg, seed, device)
        harness.log("model built")
        self.model.record_routes(True)
        harness.settle(device)
        self.outputs = []
        for _ in range(WARMUP_CALLS):
            self.call()
        self.outputs = []

    def call(self):
        k = len(self.outputs) % self.pool.shape[0]
        ids = self.pool[k].to(self.device, non_blocking=True)
        logits, _ = self.prefill(self.model, ids)
        routes = self.model.take_routes()
        self.outputs.append((k, logits.float().cpu(), routes))
        return ids.shape[0]

    def finish(self):
        out = {"pool": self.pool, "outputs": self.outputs}
        failed = sum(not bool(torch.isfinite(logits).all()) for _, logits, _ in self.outputs)
        del self.model
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out, failed


def setup(cell: dict, seed: int, device) -> Session:
    return Session(cell, seed, device)


def sample(cell: dict, seed: int, out: dict):
    """The checked rows drawn from the seed among the window's calls: their
    token ids (Bt, L), the program's logits (Bt, vocab) and its expert
    choices per MoE layer (Bt, L, k)."""
    batch, outputs = cell["traffic_spec"]["batch"], out["outputs"]
    rng = np.random.default_rng(seed)
    n = min(cell["traffic_spec"]["check_rows"], len(outputs) * batch)
    picks = [(j // batch, j % batch) for j in
             sorted(rng.choice(len(outputs) * batch, size=n, replace=False).tolist())]
    ids = torch.stack([out["pool"][outputs[c][0], r] for c, r in picks])
    got = torch.stack([outputs[c][1][r] for c, r in picks])
    routes = [torch.stack([outputs[c][2][layer][r] for c, r in picks])
              for layer in range(len(outputs[0][2]))]
    return ids, got, routes


def _numbers(got, want, stats) -> dict:
    return {"logit_rel_err": row_rel_err(got, want),
            "routes_beyond_margin": float(stats["beyond_margin"]),
            "router_near_ties": float(stats["near_ties"]),
            "largest_tie_gap": stats["max_tie_gap"]}


def check(cell: dict, seed: int, out: dict, device) -> dict:
    ids, got, routes = sample(cell, seed, out)
    want, stats = jamba.reference_last_logits(cell["config_spec"], seed, ids, device,
                                              routes=routes, margin=cell["router_tie_margin"])
    return _numbers(got, want, stats)


def control(cell: dict, seed: int, out: dict, device) -> dict:
    """The control's reading: the reference in fp8 in the program's place,
    its own expert choices standing for the program's."""
    ids, _, _ = sample(cell, seed, out)
    cfg = cell["config_spec"]
    fp8, stats8 = jamba.reference_last_logits(cfg, seed, ids, device, precision="fp8")
    want, stats = jamba.reference_last_logits(cfg, seed, ids, device, routes=stats8["routes"],
                                              margin=cell["router_tie_margin"])
    return {"fp8": _numbers(fp8, want, stats)}


def end_to_end(stats: dict) -> dict:
    return {"eval_clips_per_s": (stats["clips"] / stats["window_s"], "clips/s"),
            "latency_p95_ms": (harness.percentile(stats["latencies"], 95) * 1e3, "ms")}
