from aum_tpu_torch.ops.conv1d import causal_conv1d, causal_conv1d_plain
from aum_tpu_torch.ops.norms import fused_add_norm, layer_norm, rms_norm
from aum_tpu_torch.ops.scan_ref import selective_scan_ref
from aum_tpu_torch.ops.selective_scan import (
    selective_scan_bwd,
    selective_scan_dual,
    selective_scan_dual_plain,
)

__all__ = [
    "causal_conv1d",
    "causal_conv1d_plain",
    "fused_add_norm",
    "layer_norm",
    "rms_norm",
    "selective_scan_ref",
    "selective_scan_bwd",
    "selective_scan_dual",
    "selective_scan_dual_plain",
]
