"""What the per-layer metric files read from a traced stretch (``trace.View``).
Each returns None where the stretch has nothing to read."""

from __future__ import annotations

from benchmark import roofline

BYTES_PER_ELEMENT = 2  # the scans' bf16 streams


def idle_pct(view):
    """One minus the union of the device's kernel, copy and set intervals
    over the stretch's seconds, in percent."""
    if view.window_s <= 0 or not view.device_ops:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)


def mfu_pct(view, passes: int):
    """The model's FLOPs for the stretch's clips (``passes`` times the
    forward's: products, conv and scan from the configuration's shapes) over
    its seconds, over the dense bf16 peak, in percent."""
    if view.window_s <= 0 or not view.device_ops:
        return None
    flops = passes * roofline.aum_forward_flops_per_clip(view.cell["config_spec"]["model"])
    return 100.0 * flops * view.clips / view.window_s / roofline.BF16_TENSOR_FLOPS_PER_S


def elementwise_ms_per_clip(view):
    """Device ms per clip of the kernels that are neither the port's
    (``metrics/kernels/port/``) nor a library's (``metrics/kernels/library/``)."""
    if not view.clips:
        return None
    named = {id(k) for k in view.matching("port") + view.matching("library")}
    return sum(k[2] for k in view.kernels if id(k) not in named) / 1e3 / view.clips


SCAN_BOUNDS = {
    "scan_fwd_dual": roofline.scan_fwd_dual_s,
    "scan_fwd_single": roofline.scan_fwd_single_s,
    "scan_bwd_dual": lambda *shape: roofline.scan_bwd_s(*shape, ndir=2),
}


def scan_roofline_pct(view, op: str):
    """The op's least time at the cell's shapes (one call a layer a call of
    the stretch) over the device time of the kernels named in
    ``metrics/kernels/<op>/``, in percent."""
    kernels = view.matching(op)
    if not kernels:
        return None
    s = roofline.aum_shapes(view.cell["config_spec"]["model"])
    bound = SCAN_BOUNDS[op](view.cell["traffic_spec"]["batch"], s["tokens"], s["d_inner"],
                            s["d_state"], BYTES_PER_ELEMENT)
    return 100.0 * bound * s["depth"] * view.calls / (sum(k[2] for k in kernels) / 1e6)
