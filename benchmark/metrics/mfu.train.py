"""The whole train step's share of the card's dense bf16 peak (989 TFLOP/s):
the backward counted as twice the forward, recompute not counted."""

from benchmark import readers

NAME = "mfu.train"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "whole step"
MOVES = "train_clips_per_s"
WORKLOADS = ["aum-base-fobi.train-b48"]


def read(view):
    return readers.mfu_pct(view, passes=3)
