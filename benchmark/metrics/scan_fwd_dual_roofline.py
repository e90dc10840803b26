"""The dual scan forward (eval, both directions) against its roofline."""

from benchmark import readers

NAME = "scan_fwd_dual_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "eval_clips_per_s"
WORKLOADS = ["aum-base-fobi.eval-b64"]


def read(view):
    return readers.scan_roofline_pct(view, "scan_fwd_dual")
