"""Share of the traced stretch with no kernel, copy or set on the device."""

from benchmark import readers

NAME = "idle_pct.eval"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "eval_clips_per_s"
WORKLOADS = ["aum-base-fobi.eval-b64"]


def read(view):
    return readers.idle_pct(view)
