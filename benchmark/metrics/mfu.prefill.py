"""The whole prefill call's share of the card's dense bf16 peak (989 TFLOP/s), by
benchmark/jamba.py's FLOP count."""

from benchmark import jamba

NAME = "mfu.prefill"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "whole step"
MOVES = "eval_clips_per_s"
WORKLOADS = ["jamba2-mini-pp2.prefill-32k"]


def read(view):
    return jamba.mfu_pct(view)
