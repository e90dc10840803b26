from aum_tpu_torch.ops.conv1d import causal_conv1d, causal_conv1d_plain, causal_conv1d_update
from aum_tpu_torch.ops.norms import fused_add_norm, layer_norm, rms_norm
from aum_tpu_torch.ops.scan_ref import selective_scan_ref
from aum_tpu_torch.ops.selective_scan import (
    selective_scan,
    selective_scan_bwd,
    selective_scan_dual,
    selective_scan_dual_plain,
    selective_scan_plain,
)
from aum_tpu_torch.ops.state_update import selective_state_update

__all__ = [
    "causal_conv1d",
    "causal_conv1d_plain",
    "causal_conv1d_update",
    "fused_add_norm",
    "layer_norm",
    "rms_norm",
    "selective_scan",
    "selective_scan_ref",
    "selective_scan_bwd",
    "selective_scan_dual",
    "selective_scan_dual_plain",
    "selective_scan_plain",
    "selective_state_update",
]
