"""The single-direction scan forward of the 14 Mamba layers at (1, 32768, 8192, 16)
against its roofline."""

from benchmark import jamba

NAME = "scan_fwd_single_roofline.prefill"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "eval_clips_per_s"
WORKLOADS = ["jamba2-mini-pp2.prefill-32k"]


def read(view):
    return jamba.scan_roofline_pct(view)
