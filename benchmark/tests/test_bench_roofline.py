"""The op counts against the worked figures of PERF.md's kernel table, the
model's FLOPs, and the guard against JAX modules."""

import pytest

from benchmark import harness, roofline

AUM_BASE = {"spectrogram_size": [128, 1024], "patch_size": [16, 16], "strides": [16, 16],
            "embed_dim": 768, "d_state": 16, "depth": 24, "num_classes": 527,
            "bimamba_type": "v1"}


@pytest.mark.parametrize("bound, args, want_ms", [
    (roofline.scan_fwd_dual_s, (64, 513, 1536, 16, 2), 0.275),
    (roofline.scan_fwd_single_s, (64, 513, 1536, 16, 2), 0.138),
    (lambda *a: roofline.scan_bwd_s(*a, ndir=2), (12, 513, 1536, 16, 2), 0.108),
    (lambda *a: roofline.scan_bwd_s(*a, ndir=1), (12, 513, 1536, 16, 2), 0.054),
])
def test_scan_bounds_match_the_kernel_table(bound, args, want_ms):
    assert bound(*args) * 1e3 == pytest.approx(want_ms, rel=5e-3)


def test_bounds_are_operations_bound_at_these_shapes():
    # The bytes alone would give less time than the operations.
    b, L, d, n, es = 64, 513, 1536, 16, 2
    nbytes = (5 * b * L * d + 2 * b * L * n) * es
    assert nbytes / roofline.HBM_BYTES_PER_S < roofline.scan_fwd_dual_s(b, L, d, n, es)


def test_model_flops_per_clip():
    fobi = roofline.aum_forward_flops_per_clip(AUM_BASE)
    fofo = roofline.aum_forward_flops_per_clip({**AUM_BASE, "bimamba_type": "none"})
    # The products alone: 24 layers of in, x, dt and out projections at 513 tokens.
    products = 24 * 2 * 513 * (768 * 3072 + 1536 * 80 + 48 * 1536 + 1536 * 768)
    assert products < fofo < fobi < 1.06 * products
    assert fobi - fofo == 24 * roofline.SCAN_FLOPS_PER_ELEMENT * 513 * 1536 * 16
    assert 94e9 < fobi < 98e9


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "flax.linen", "aum_tpu",
                                  "aum_tpu.models"])
def test_guard_rejects(name):
    assert harness.forbidden_modules([name, "torch"]) == [name]


@pytest.mark.parametrize("name", ["aum_tpu_torch", "aum_tpu_torch.models", "jaxtyping",
                                  "aum_tpu2", "benchmark"])
def test_guard_passes(name):
    assert harness.forbidden_modules([name]) == []
