"""The Jamba cell on the CPU at a tiny size (``tiny/``: width 64, one period
of 8 layers, 4 experts, fp32), and its counts at the published size: the
prefill driver's loop and result line, the faults and the control that
``correct`` has to catch, the per-layer readers, the FLOPs and the
parameters of one pipeline stage."""

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, jamba
from benchmark.reference import jamba as ref_jamba

BENCH = Path(__file__).resolve().parents[1]
TINY = BENCH / "tests" / "tiny"
CPU = torch.device("cpu")
CELL = "tiny-jamba.prefill"
STAGE = harness.load("configs", "jamba2-mini-pp2")


def _run(trace_on=False, seed=2 ** 31 + 11):
    return harness.run(harness.load_cell(CELL, TINY), seed, 0.5, trace_on, CPU, time.time())


@pytest.mark.parametrize("trace_on", [False, True])
def test_rehearsal_result_line(trace_on, capsys):
    result = _run(trace_on)
    harness.emit(result)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["check"]) == {"logit_rel_err", "routes_beyond_margin"}
    assert line["check"]["routes_beyond_margin"]["value"] == 0
    if not trace_on:
        assert set(line["metrics"]) == {"setup_s", "eval_clips_per_s", "latency_p95_ms"}


def test_readers_on_a_traced_stretch():
    """Each reader returns a number or None on a CPU stretch (no device
    kernels there), never raises."""
    from benchmark import trace

    cell = harness.load_cell(CELL, TINY)
    session = harness.driver("prefill").setup(cell, 5, CPU)
    stretch = trace.Stretch()
    stretch.start()
    clips = session.call() + session.call()
    stretch.stop()
    view = stretch.view(2, clips, cell)
    for read in (jamba.mfu_pct, jamba.elementwise_ms_per_clip, jamba.scan_roofline_pct,
                 jamba.attention_roofline_pct):
        value = read(view)
        assert value is None or value >= 0.0


def test_altered_logits_make_correct_false(monkeypatch):
    import aum_tpu_torch.models.lm as lm

    real = lm.prefill

    def broken(model, ids):
        logits, state = real(model, ids)
        return logits + 0.01 * logits.abs().max(), state
    monkeypatch.setattr(lm, "prefill", broken)
    result = _run()
    assert result["correct"] is False
    assert result["check"]["logit_rel_err"]["value"] > result["check"]["logit_rel_err"]["limit"]


def test_control_fails_the_limits():
    cell = harness.load_cell(CELL, TINY)
    drv = harness.driver(cell["traffic_spec"]["driver"])
    session = drv.setup(cell, 31, CPU)
    for _ in range(3):
        session.call()
    out, _ = session.finish()
    program = drv.check(cell, 31, out, CPU)
    assert all(program[k] <= v for k, v in cell["limits"].items())
    for numbers in drv.control(cell, 31, out, CPU).values():
        assert any(numbers[k] > v for k, v in cell["limits"].items())


def test_tie_rule_counts_a_forced_disagreement():
    """Choices the reference's probabilities do not tie count beyond the margin."""
    cell = harness.load_cell(CELL, TINY)
    drv = harness.driver("prefill")
    session = drv.setup(cell, 7, CPU)
    session.call()
    out, _ = session.finish()
    k, logits, routes = out["outputs"][0]
    out["outputs"][0] = (k, logits, [(r + 1) % cell["config_spec"]["num_experts"]
                                      for r in routes])
    numbers = drv.check(cell, 7, out, CPU)
    assert numbers["routes_beyond_margin"] > 0


def test_stage_counts():
    assert STAGE["num_hidden_layers"] == 16 and STAGE["reduced"] == ["num_hidden_layers"]
    kinds = ref_jamba.layer_kinds(STAGE)
    assert sum(m == "mamba" for m, _ in kinds) == 14 and sum(f == "moe" for _, f in kinds) == 8
    assert jamba.param_count(STAGE) == pytest.approx(26.05e9, rel=2e-3)
    flops = jamba.forward_flops_per_call(STAGE, 1, 32768)
    assert flops == pytest.approx(3.97e14, rel=3e-3)
    # The attention core of both layers is 1.76e13 of it.
    assert 2 * jamba.attention_core_flops(STAGE, 1, 32768) == pytest.approx(1.76e13, rel=3e-3)


def test_stage_keeps_the_published_keys():
    """Every key of the published config.json is in the stage's file with its
    value, but the one that ``reduced`` names."""
    published = {"attn_layer_offset": 4, "attn_layer_period": 8, "expert_layer_offset": 1,
                 "expert_layer_period": 2, "hidden_act": "silu", "hidden_size": 4096,
                 "intermediate_size": 14336, "mamba_conv_bias": True, "mamba_d_conv": 4,
                 "mamba_d_state": 16, "mamba_dt_rank": 256, "mamba_expand": 2,
                 "mamba_proj_bias": False, "max_position_embeddings": 262144,
                 "model_type": "jamba", "num_attention_heads": 32, "num_experts": 16,
                 "num_experts_per_tok": 2, "num_hidden_layers": 32, "num_key_value_heads": 8,
                 "num_logits_to_keep": 1, "rms_norm_eps": 1e-06, "sliding_window": None,
                 "tie_word_embeddings": False, "use_mamba_kernels": True, "vocab_size": 65536}
    differ = {k for k, v in published.items() if STAGE[k] != v}
    assert differ == set(STAGE["reduced"])


def test_every_leaf_has_a_rule_and_the_draw_repeats():
    for key in ref_jamba.param_shapes(STAGE):
        assert any(__import__("re").fullmatch(r["match"], key) for r in STAGE["weights"]), key
    a = jamba.draw_leaf(STAGE, "model.layers.1.feed_forward.router.weight", (16, 4096), 9, CPU)
    b = jamba.draw_leaf(STAGE, "model.layers.1.feed_forward.router.weight", (16, 4096), 9, CPU)
    c = jamba.draw_leaf(STAGE, "model.layers.3.feed_forward.router.weight", (16, 4096), 9, CPU)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b) and not torch.equal(a, c)
    assert jamba.draw_leaf(STAGE, "model.layers.0.mamba.D", (8,), 9, CPU).dtype == torch.float32
