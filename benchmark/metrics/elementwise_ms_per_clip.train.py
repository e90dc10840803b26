"""Device ms per clip of the plain-torch elementwise work and reductions."""

from benchmark import readers

NAME = "elementwise_ms_per_clip.train"
UNIT = "ms/clip"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "model"
MOVES = "train_clips_per_s"
WORKLOADS = ["aum-base-fobi.train-b48"]


def read(view):
    return readers.elementwise_ms_per_clip(view)
