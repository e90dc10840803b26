"""The whole served request's share of the card's dense bf16 peak (989 TFLOP/s);
the frontend's FFT and mel product are not counted."""

from benchmark import readers

NAME = "mfu.serve"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "whole step"
MOVES = "serve_clips_per_s"
WORKLOADS = ["aum-base-fofo-wav.serve-b64"]


def read(view):
    return readers.mfu_pct(view, passes=1)
