"""SDPA's causal attention core of the 2 attention layers against the dense bf16
peak."""

from benchmark import jamba

NAME = "attention_roofline.prefill"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "eval_clips_per_s"
WORKLOADS = ["jamba2-mini-pp2.prefill-32k"]


def read(view):
    return jamba.attention_roofline_pct(view)
