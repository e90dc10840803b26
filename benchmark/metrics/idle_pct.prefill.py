"""Share of the traced stretch with no kernel, copy or set on the device."""

from benchmark import readers

NAME = "idle_pct.prefill"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "eval_clips_per_s"
WORKLOADS = ["jamba2-mini-pp2.prefill-32k"]


def read(view):
    return readers.idle_pct(view)
