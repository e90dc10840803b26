"""Device ms per 32k-token document of the plain-torch elementwise work and
reductions: the MoE's routing and the dt/B/C norms among them."""

from benchmark import jamba

NAME = "elementwise_ms_per_clip.prefill"
UNIT = "ms/clip"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "model"
MOVES = "eval_clips_per_s"
WORKLOADS = ["jamba2-mini-pp2.prefill-32k"]


def read(view):
    return jamba.elementwise_ms_per_clip(view)
