"""The scan backward of both directions against its roofline."""

from benchmark import readers

NAME = "scan_bwd_dual_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_clips_per_s"
WORKLOADS = ["aum-base-fobi.train-b48"]


def read(view):
    return readers.scan_roofline_pct(view, "scan_bwd_dual")
