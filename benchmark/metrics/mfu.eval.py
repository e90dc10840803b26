"""The whole eval step's share of the card's dense bf16 peak (989 TFLOP/s)."""

from benchmark import readers

NAME = "mfu.eval"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "whole step"
MOVES = "eval_clips_per_s"
WORKLOADS = ["aum-base-fobi.eval-b64"]


def read(view):
    return readers.mfu_pct(view, passes=1)
