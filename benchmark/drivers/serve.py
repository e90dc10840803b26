"""Serve: a tagging service fed raw audio, one client in a closed loop.

Set-up builds the model from the seed's weights, exports it as a serving
bundle with the frontend (``serving.export_bundle``: the configuration's
fbank, pad and normalization, the traffic's batch sizes) into memory, and
loads it (``serving.load_bundle``): the bytes a bundle file would hold,
without writing them to disk. Each call is ``ServingModel.predict`` on the
next batch of the pool's pageable host waveforms; its logits come back to
the host. The check samples ``check_rows`` rows, drawn from the seed, and
compares each with the reference's fbank (float64) and fp32 model on the
same waveform.
"""

from __future__ import annotations

import torch

from benchmark import aum, harness, traffic
from benchmark.drivers.eval import checks
from benchmark.reference import fbank as ref_fbank

WARMUP_CALLS = 2


class Session:
    def __init__(self, cell: dict, seed: int, device):
        from aum_tpu_torch.serving import export_bundle, load_bundle

        cfg, tr = cell["config_spec"], cell["traffic_spec"]
        front = cfg["frontend"]
        self.pool = traffic.make_pool(tr, cfg, seed, device)
        harness.log("pool drawn")
        model, self.param_shapes = aum.build_program(cfg, seed, device)
        harness.log("model built")
        f, t = cfg["model"]["spectrogram_size"]
        blob = export_bundle(model, audio_length=t, melbins=f, batch_sizes=tr["batch_sizes"],
                             mean=front["mean"], std=front["std"], include_frontend=True,
                             sample_rate=front["sample_rate"],
                             wav_samples=self.pool.shape[-1])
        del model
        harness.log("bundle exported")
        self.served = load_bundle(blob, device)
        harness.log("bundle loaded")
        del blob
        harness.settle(device)
        self.outputs = []
        for _ in range(WARMUP_CALLS):
            self.call()
        self.outputs = []

    def call(self):
        k = len(self.outputs) % self.pool.shape[0]
        logits = self.served.predict(self.pool[k]).float().cpu()
        self.outputs.append((k, logits))
        return logits.shape[0]

    def finish(self):
        out = {"pool": self.pool, "outputs": self.outputs, "param_shapes": self.param_shapes}
        failed = sum(not bool(torch.isfinite(logits).all()) for _, logits in self.outputs)
        del self.served
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out, failed


def setup(cell: dict, seed: int, device) -> Session:
    return Session(cell, seed, device)


def reference(cell: dict, seed: int, pool, rows, param_shapes, device,
              precision: str = "fp32") -> torch.Tensor:
    cfg = cell["config_spec"]
    front = cfg["frontend"]
    f, t = cfg["model"]["spectrogram_size"]
    wav = torch.stack([pool[k, r] for k, r in rows]).to(device)
    x = ref_fbank.log_mel(wav, sample_rate=front["sample_rate"], melbins=f, audio_length=t,
                          mean=front["mean"], std=front["std"]).float()
    params = aum.seeded_params(cfg, param_shapes, seed, device)
    return aum.reference_logits(cfg, params, x, precision).cpu()


check, control = checks(reference)


def end_to_end(stats: dict) -> dict:
    # Names of their own: the pageable copy on a shared host spreads these
    # runs wider than the eval cell's, and a bound is one per metric.
    return {"serve_clips_per_s": (stats["clips"] / stats["window_s"], "clips/s"),
            "serve_latency_p95_ms": (1e3 * harness.percentile(stats["latencies"], 95), "ms")}
