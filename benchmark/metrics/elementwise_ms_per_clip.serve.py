"""Device ms per clip of the plain-torch elementwise work and reductions."""

from benchmark import readers

NAME = "elementwise_ms_per_clip.serve"
UNIT = "ms/clip"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "model"
MOVES = "serve_clips_per_s"
WORKLOADS = ["aum-base-fofo-wav.serve-b64"]


def read(view):
    return readers.elementwise_ms_per_clip(view)
