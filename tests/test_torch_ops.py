"""The PyTorch port's ops (``aum_tpu_torch.ops``) against the JAX package, on the CPU.

On a CPU tensor each port wrapper runs its kernel's plain PyTorch version, so
these tests hold that version to the JAX op; the CUDA kernels themselves are
held to the plain versions on the card by ``chip_smoke.py``. The JAX scan and
conv kernels run here in Pallas interpret mode, as the JAX package's own
tests run them. Inputs are drawn with numpy from fixed seeds and handed to
both frameworks. torch is imported inside the tests, as in the other test
modules that use it.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from aum_tpu.ops import conv1d as jconv
from aum_tpu.ops import norms as jnorms
from aum_tpu.ops.scan_ref import selective_scan_ref as jscan_ref
from aum_tpu.ops.selective_scan import selective_scan_dual as jscan_dual

DTYPES = ("float32", "bfloat16")


def _torch(a, dtype="float32"):
    import torch

    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy()


def _scan_args(seed, bsz=2, seqlen=37, d=16, n=4):
    """(u, delta, A, B, C, D, z, delta_bias) as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bsz, seqlen, d)),
            rng.standard_normal((bsz, seqlen, d)) * 0.5,
            -np.exp(rng.standard_normal((d, n)) * 0.5),
            rng.standard_normal((bsz, seqlen, n)),
            rng.standard_normal((bsz, seqlen, n)),
            rng.standard_normal(d),
            rng.standard_normal((bsz, seqlen, d)),
            rng.standard_normal(d) * 0.1)


# Streams (u, delta, B, C, z) take the test dtype; A, D and the bias stay fp32.
_STREAMS = (0, 1, 3, 4, 6)


def _as_jax(args, dtype):
    return tuple(jnp.asarray(a, dtype if i in _STREAMS else "float32")
                 for i, a in enumerate(args))


def _as_torch(args, dtype):
    return tuple(_torch(a, dtype if i in _STREAMS else "float32")
                 for i, a in enumerate(args))


# fp32: the same fp32 recurrence in another op order (2e-5, the bound the JAX
# package's own dual-kernel test uses). bf16: both cast one fp32 result to
# bf16, so a value on a rounding boundary may differ by one bf16 ulp
# (2^-7 relative at most); dt is rounded to bf16 identically on both sides.
SCAN_TOL = {"float32": 2e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("shared", [True, False], ids=["v1_shared", "v2_separate"])
def test_selective_scan_dual_matches_jax_kernel(shared, n, dtype):
    from aum_tpu_torch.ops import selective_scan_dual

    args_f = _scan_args(10 + n, n=n)
    args_r = args_f if shared else _scan_args(20 + n, n=n)
    if shared:  # bimamba v1: same operands, its own A
        args_r = args_f[:2] + (args_f[2] * 0.5,) + args_f[3:]
    want = jscan_dual(_as_jax(args_f, dtype), _as_jax(args_r, dtype),
                      d_block=8, l_chunk=16)
    tf = _as_torch(args_f, dtype)
    tr = _as_torch(args_r, dtype)
    if shared:  # the same tensors, as the v1 mixer passes them
        tr = tf[:2] + (tr[2],) + tf[3:]
    got = selective_scan_dual(tf, tr)
    tol = SCAN_TOL[dtype]
    for g, w in zip(got, want):
        assert str(g.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_ref_matches_jax_oracle(reverse):
    from aum_tpu_torch.ops import selective_scan_ref

    args = _scan_args(3, n=8)
    u, delta, A, B, C, D, z, bias = args
    want = jscan_ref(*_as_jax(args[:6], "float32"), z=jnp.asarray(z, "float32"),
                     delta_bias=jnp.asarray(bias, "float32"),
                     delta_softplus=True, reverse=reverse)
    got = selective_scan_ref(*_as_torch(args[:6], "float32"), z=_torch(z),
                             delta_bias=_torch(bias), delta_softplus=True,
                             reverse=reverse)
    # fp32 sequential recurrences; exp vs exp and einsum order only.
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ["silu", None])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_causal_conv1d_matches_jax(reverse, with_bias, activation, dtype):
    from aum_tpu_torch.ops import causal_conv1d

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 37, 24))
    w = rng.uniform(-0.5, 0.5, (24, 4))
    b = rng.uniform(-0.5, 0.5, 24) if with_bias else None
    jb = None if b is None else jnp.asarray(b, dtype)
    got = _np(causal_conv1d(_torch(x, dtype), _torch(w, dtype),
                            None if b is None else _torch(b, dtype),
                            activation=activation, reverse=reverse))
    kernel = np.asarray(jconv.causal_conv1d(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), jb, activation=activation,
        reverse=reverse, use_kernel=True, interpret=True), np.float32)
    xla = np.asarray(jconv.causal_conv1d_xla(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype), jb, activation=activation,
        reverse=reverse), np.float32)
    if dtype == "float32":
        # Same fp32 sums in the same order as _conv_kernel and the XLA form.
        np.testing.assert_allclose(got, kernel, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, xla, rtol=1e-6, atol=1e-6)
    else:
        # The JAX kernel (compute_f32) also sums in fp32 and casts once: one
        # bf16 ulp at a rounding boundary.
        np.testing.assert_allclose(got, kernel, rtol=1e-2, atol=1e-2)
        # The XLA form rounds to bf16 after every tap, the bias and the SiLU;
        # its partial sums reach ~3, where one bf16 ulp is 2^-6, so the two
        # differ by about one ulp of the largest partial sum.
        np.testing.assert_allclose(got, xla, rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("width", [3, 5])
def test_conv_kernel_wrapper_takes_width_4_only(width):
    """The kernel is built for the mixer's width; another is refused before
    any build or launch (the plain form, used on the CPU, takes any width)."""
    import torch

    from aum_tpu_torch.ops.conv1d import causal_conv1d_cuda, causal_conv1d_plain

    x, w = torch.zeros((1, 8, 6)), torch.zeros((6, width))
    with pytest.raises(ValueError, match="K=4"):
        causal_conv1d_cuda(x, w)
    assert causal_conv1d_plain(x, w).shape == x.shape


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm_type", ["rms", "layer"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_fused_add_norm_matches_jax(with_residual, norm_type, dtype):
    from aum_tpu_torch.ops import fused_add_norm

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 32)) * 2.0
    res = rng.standard_normal((2, 9, 32)) if with_residual else None
    w = 1.0 + 0.1 * rng.standard_normal(32)
    b = 0.1 * rng.standard_normal(32) if norm_type == "layer" else None
    jy, jres = jnorms.fused_add_norm(
        jnp.asarray(x, dtype), jnp.asarray(w, dtype),
        None if b is None else jnp.asarray(b, "float32"),
        residual=None if res is None else jnp.asarray(res, "float32"),
        prenorm=True, norm_type=norm_type)
    ty, tres = fused_add_norm(
        _torch(x, dtype), _torch(w, dtype), None if b is None else _torch(b),
        residual=None if res is None else _torch(res), prenorm=True,
        norm_type=norm_type)
    assert str(ty.dtype) == f"torch.{dtype}" and str(tres.dtype) == "torch.float32"
    # The residual sum is exact in fp32 on both sides; the fp32 norm differs
    # in reduction order (1e-5); a bf16 output may differ by one ulp.
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(tres), np.asarray(jres), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32), rtol=tol, atol=tol)
