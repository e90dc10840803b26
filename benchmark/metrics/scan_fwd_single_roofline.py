"""The single-direction scan forward against its roofline."""

from benchmark import readers

NAME = "scan_fwd_single_roofline"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "serve_clips_per_s"
WORKLOADS = ["aum-base-fofo-wav.serve-b64"]


def read(view):
    return readers.scan_roofline_pct(view, "scan_fwd_single")
