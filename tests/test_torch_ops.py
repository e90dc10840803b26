"""The PyTorch port's ops (``aum_tpu_torch.ops``) against the JAX package, on the CPU.

On a CPU tensor each port wrapper runs its kernel's plain PyTorch version, so
these tests hold that version to the JAX op; the CUDA kernels themselves are
held to the plain versions on the card by ``chip_smoke.py``. The JAX scan and
conv kernels run here in Pallas interpret mode, as the JAX package's own
tests run them: the dual scan, and the single-direction scan (forward,
``with_state``, and their grads through ``_fwd_kernel_z`` with saved states
and ``_bwd_kernel``, the with_state grads with its gfin in and dx0 out), each
jitted once per form and shared. Inputs are drawn with
numpy from fixed seeds and handed to both frameworks. torch is imported
inside the tests, as in the other test modules that use it.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.ops import conv1d as jconv
from aum_tpu.ops import norms as jnorms
from aum_tpu.ops.scan_ref import selective_scan_ref as jscan_ref
from aum_tpu.ops.selective_scan import selective_scan as jscan
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

# One compile per (n, dtype): the v1 and v2 cases share it.
_jscan_dual = jax.jit(functools.partial(jscan_dual, d_block=8, l_chunk=16))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("shared", [True, False], ids=["v1_shared", "v2_separate"])
def test_selective_scan_dual_matches_jax_kernel(shared, n, dtype):
    from aum_tpu_torch.ops import selective_scan_dual

    args_f = _scan_args(10 + n, n=n)
    args_r = args_f if shared else _scan_args(20 + n, n=n)
    if shared:  # bimamba v1: same operands, its own A
        args_r = args_f[:2] + (args_f[2] * 0.5,) + args_f[3:]
    want = _jscan_dual(_as_jax(args_f, dtype), _as_jax(args_r, dtype))
    tf = _as_torch(args_f, dtype)
    tr = _as_torch(args_r, dtype)
    if shared:  # the same tensors, as the v1 mixer passes them
        tr = tf[:2] + (tr[2],) + tf[3:]
    got = selective_scan_dual(tf, tr)
    tol = SCAN_TOL[dtype]
    for g, w in zip(got, want):
        assert str(g.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=tol, atol=tol)


# --- the single-direction scan -------------------------------------------------

def _single_args():
    """(u, delta, A, B, C, D, z, delta_bias) at B=2, L=37, D=32, N=16."""
    return _scan_args(40, d=32, n=16)


@pytest.fixture(scope="module")
def jax_single_scan():
    """The JAX ``selective_scan(use_kernel=True, interpret=True)`` on
    ``_single_args()``, l_chunk 8 (an overhang chunk at L=37), with bias,
    softplus, D and z, per direction: fp32 (out, the 8 grads of sum(out *
    w)) from one jitted vjp, bf16 out, and the with_state form's ((out, final
    state), the 9 grads of sum(out * w) + sum(final state * wf), d(x0) last)
    from a random x0, one jitted vjp (``_make_scan_x0``)."""
    rng = np.random.default_rng(41)
    x0 = rng.standard_normal((2, 32, 16))
    w = rng.standard_normal((2, 37, 32))
    wf = rng.standard_normal((2, 32, 16))
    args = _single_args()
    out = {"x0": x0, "w": w, "wf": wf}
    for reverse in (False, True):
        def scan(*a, **kw):
            return jscan(*a[:6], z=a[6], delta_bias=a[7], delta_softplus=True,
                         reverse=reverse, use_kernel=True, interpret=True, l_chunk=8, **kw)

        def out_and_grads(a, w):
            y, vjp = jax.vjp(scan, *a)
            return y, vjp(w)

        out["float32", reverse] = jax.jit(out_and_grads)(_as_jax(args, "float32"),
                                                         jnp.asarray(w, jnp.float32))
        out["bfloat16", reverse] = (jax.jit(scan)(*_as_jax(args, "bfloat16")), None)

        def state_out_and_grads(a, x0, w, wf):
            outs, vjp = jax.vjp(lambda *a: scan(*a[:8], initial_state=a[8],
                                                return_final_state=True), *a, x0)
            return outs, vjp((w, wf))

        out["state", reverse] = jax.jit(state_out_and_grads)(
            _as_jax(args, "float32"), *(jnp.asarray(a, jnp.float32) for a in (x0, w, wf)))
    return {k: jax.device_get(v) for k, v in out.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_selective_scan_matches_jax_kernel(jax_single_scan, reverse, dtype):
    from aum_tpu_torch.ops import selective_scan

    args = _as_torch(_single_args(), dtype)
    got = selective_scan(*args[:7], delta_bias=args[7], delta_softplus=True, reverse=reverse)
    want = jax_single_scan[dtype, reverse][0]
    assert str(got.dtype) == f"torch.{dtype}"
    tol = SCAN_TOL[dtype]  # the dual scan's bounds, for the same reasons
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("reverse", [False, True])
def test_selective_scan_with_state_matches_jax_kernel(jax_single_scan, reverse):
    """Out and final state (the state after position 0 when reversed) from a
    carried-in state, in the reference's (B, D, N) layout."""
    import torch

    from aum_tpu_torch.ops import selective_scan

    args = _as_torch(_single_args(), "float32")
    got, fin = selective_scan(*args[:7], delta_bias=args[7], delta_softplus=True,
                              reverse=reverse, initial_state=_torch(jax_single_scan["x0"]),
                              return_final_state=True)
    (want, want_fin), _ = jax_single_scan["state", reverse]
    assert tuple(fin.shape) == (2, 32, 16) and fin.dtype == torch.float32
    # fp32 recurrences, exp vs exp2: the forward's bound.
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(fin), np.asarray(want_fin), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_selective_scan_grads_match_jax_kernels(jax_single_scan, reverse):
    """All 8 grads of the single-direction scan (``_Scan``; its plain
    backward here) against JAX's save_states ``_fwd_kernel_z`` +
    ``_bwd_kernel``, fp32, each within 2e-4 of its largest element (the JAX
    package's own bound for its kernel's grads)."""
    from aum_tpu_torch.ops import selective_scan

    leaves = [t.requires_grad_() for t in _as_torch(_single_args(), "float32")]
    y = selective_scan(*leaves[:7], delta_bias=leaves[7], delta_softplus=True, reverse=reverse)
    (y * _torch(jax_single_scan["w"])).sum().backward()
    for name, t, w in zip(("u", "delta", "A", "B", "C", "D", "z", "bias"), leaves,
                          jax_single_scan["float32", reverse][1]):
        w = np.asarray(w, np.float32)
        err = float(np.abs(_np(t.grad) - w).max() / np.abs(w).max())
        assert err <= 2e-4, (name, err)


def test_selective_scan_state_forms_run_without_grad_only():
    """D or z may be None (the scan without them; their grads:
    tests/test_torch_sizes.py); without grad the state forms run (the final
    state in (B, D, N)); under grad the state forms and the form without the
    softplus run too (their grads: the tests below)."""
    import torch

    from aum_tpu_torch.ops import selective_scan

    args = [t.requires_grad_() for t in _as_torch(_scan_args(3), "float32")]
    y_no_d = selective_scan(*args[:5], None, args[6])
    assert y_no_d.shape == args[0].shape and y_no_d.requires_grad
    with torch.no_grad():
        y, fin = selective_scan(*args[:7], delta_bias=args[7], return_final_state=True)
    assert y.shape == args[0].shape and tuple(fin.shape) == (2, 16, 4)
    assert not y.requires_grad and not fin.requires_grad
    y, fin = selective_scan(*args[:7], delta_bias=args[7], delta_softplus=True,
                            return_final_state=True)
    assert y.requires_grad and fin.requires_grad and tuple(fin.shape) == (2, 16, 4)
    y2 = selective_scan(*args[:7], delta_bias=args[7])
    (y.sum() + fin.sum() + y2.sum() + y_no_d.sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in args)


SCAN_NAMES = ("u", "delta", "A", "B", "C", "D", "z", "bias")


def _assert_grads_close(names, got, want, tol):
    """Each grad within tol of its largest element."""
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32)
        err = float(np.abs(_np(g) - w).max() / np.abs(w).max())
        assert err <= tol, (name, err)


@pytest.mark.parametrize("reverse", [False, True])
def test_selective_scan_with_state_grads_match_jax_kernels(jax_single_scan, reverse):
    """The 8 grads and d(x0) of the with_state scan under grad (``_Scan`` in
    its state form; its plain backward here), with a loss that reads both
    outputs, against JAX's ``_make_scan_x0`` (``_fwd_kernel_z`` with saved
    states and x0, ``_bwd_kernel`` with gfin in and dx0 out), fp32, 2e-4 of
    each grad's largest element as for the grads without state."""
    from aum_tpu_torch.ops import selective_scan

    leaves = [t.requires_grad_() for t in _as_torch(_single_args(), "float32")]
    x0 = _torch(jax_single_scan["x0"]).requires_grad_()
    y, fin = selective_scan(*leaves[:7], delta_bias=leaves[7], delta_softplus=True,
                            reverse=reverse, initial_state=x0, return_final_state=True)
    ((y * _torch(jax_single_scan["w"])).sum()
     + (fin * _torch(jax_single_scan["wf"])).sum()).backward()
    _, want = jax_single_scan["state", reverse]
    _assert_grads_close(SCAN_NAMES + ("x0",), [t.grad for t in leaves + [x0]], want, 2e-4)


def test_selective_scan_no_softplus_grads_match_jax_kernel():
    """``delta_softplus=False`` under grad: dt = delta + bias as given, and
    ddelta = ddt (no sigmoid), against JAX's kernels with ``softplus=False``;
    delta is made positive first (a pre-activated dt), fp32, 2e-4."""
    from aum_tpu_torch.ops import selective_scan

    args = list(_scan_args(42, d=24, n=8))
    args[1] = np.log1p(np.exp(args[1]))
    w = np.random.default_rng(43).standard_normal(args[0].shape)

    def scan(*a):
        return jscan(*a[:6], z=a[6], delta_bias=a[7], delta_softplus=False,
                     use_kernel=True, interpret=True, d_block=8, l_chunk=8)

    def grads(a, w):
        return jax.vjp(scan, *a)[1](w)

    want = jax.jit(grads)(_as_jax(args, "float32"), jnp.asarray(w, jnp.float32))
    leaves = [t.requires_grad_() for t in _as_torch(args, "float32")]
    y = selective_scan(*leaves[:7], delta_bias=leaves[7])
    (y * _torch(w)).sum().backward()
    _assert_grads_close(SCAN_NAMES, [t.grad for t in leaves], want, 2e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_selective_scan_chained_segments_match_unsplit(reverse):
    """A scan split at an uneven point, the second segment started from the
    first one's final state (reverse: the right-hand segment first), gives
    the unsplit scan's outputs and all grads under autograd: the property
    sequence parallelism rests on (plain path, fp32)."""
    import torch

    from aum_tpu_torch.ops import selective_scan

    raw = _as_torch(_scan_args(44, d=24, n=8), "float32")
    w = _torch(np.random.default_rng(45).standard_normal((2, 37, 24)))
    split = 15
    results = []
    for chained in (False, True):
        leaves = [t.clone().requires_grad_() for t in raw]
        u, delta, A, B, C, D, z, bias = leaves

        def scan(lo, hi, **kw):
            return selective_scan(u[:, lo:hi], delta[:, lo:hi], A, B[:, lo:hi], C[:, lo:hi],
                                  D, z[:, lo:hi], delta_bias=bias, delta_softplus=True,
                                  reverse=reverse, **kw)

        if not chained:
            y = scan(0, 37)
        else:
            first, second = ((split, 37), (0, split)) if reverse else ((0, split), (split, 37))
            y_a, state = scan(*first, return_final_state=True)
            y_b = scan(*second, initial_state=state)
            y = torch.cat((y_b, y_a) if reverse else (y_a, y_b), dim=1)
        (y * w).sum().backward()
        results.append((y.detach(), [t.grad for t in leaves]))
    (y_ref, g_ref), (y_got, g_got) = results
    # The same fp32 steps in the same order; only the sums of dA, dD and
    # dbias over the two segments are grouped differently.
    np.testing.assert_allclose(_np(y_got), _np(y_ref), rtol=1e-6, atol=1e-6)
    _assert_grads_close(SCAN_NAMES, g_got, [_np(g) for g in g_ref], 1e-5)


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


@pytest.mark.parametrize("seqlen,d,offset", [(37, 36, 0), (37, 24, 1), (1, 24, 0)],
                         ids=["d36", "odd_offset", "l1"])
def test_causal_conv1d_edges_match_jax(seqlen, d, offset):
    """The conv kernel's edges that the card checks (``chip_smoke.py``
    ``_check_edges``), its plain version against the JAX kernel in interpret
    mode, fp32, causal and anti-causal: D=36 (not whole 8-channel vectors),
    x a column slice at an odd channel offset (a view here, a copy in JAX),
    and L=1."""
    from aum_tpu_torch.ops import causal_conv1d

    rng = np.random.default_rng(11)
    xz = rng.standard_normal((2, seqlen, 2 * d + 1))
    w = rng.uniform(-0.5, 0.5, (d, 4))
    b = rng.uniform(-0.5, 0.5, d)
    x = _torch(xz)[..., offset:offset + d]
    for reverse in (False, True):
        got = causal_conv1d(x, _torch(w), _torch(b), activation="silu", reverse=reverse)
        want = jconv.causal_conv1d(
            jnp.asarray(xz[..., offset:offset + d], jnp.float32), jnp.asarray(w, jnp.float32),
            jnp.asarray(b, jnp.float32), activation="silu", reverse=reverse, use_kernel=True,
            interpret=True)
        # Same fp32 sums in the same order as _conv_kernel.
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("width", [3, 5])
def test_conv_kernel_wrapper_takes_width_4_only(width, monkeypatch):
    """The wrapper hands widths other than the mixer's 4 (3 and 5 here, and
    12) to the kernel: widths 1 to ``UNROLLED_WIDTHS`` (8) have their own
    instantiations, a wider one takes the general form, whose launches are
    counted apart; a width of 0 is refused before any build or launch. A
    stand-in library takes the launch; the plain form, used on the CPU,
    takes any width."""
    import contextlib
    import types

    import torch

    from aum_tpu_torch.ops import conv1d

    launched = []

    def launch(args, bsz, seqlen, d, k, *rest):
        launched.append(k)
        return 0

    lib = types.SimpleNamespace(aum_causal_conv1d_fwd=launch, aum_conv_error_string=str)
    monkeypatch.setattr(conv1d, "_lib", lambda: lib)
    monkeypatch.setattr(conv1d.causal_conv1d, "launches", 0)
    monkeypatch.setattr(conv1d.causal_conv1d, "general_launches", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=None))
    x = torch.zeros((1, 8, 6))
    assert 1 <= width <= conv1d.UNROLLED_WIDTHS == 8
    assert conv1d.causal_conv1d_cuda(x, torch.zeros((6, width))).shape == x.shape
    assert launched == [width] and conv1d.causal_conv1d.launches == 1
    assert conv1d.causal_conv1d.general_launches == 0
    assert conv1d.causal_conv1d_cuda(x, torch.zeros((6, 12))).shape == x.shape
    assert launched == [width, 12] and conv1d.causal_conv1d.launches == 2
    assert conv1d.causal_conv1d.general_launches == 1
    with pytest.raises(ValueError, match="K >= 1"):
        conv1d.causal_conv1d_cuda(x, torch.zeros((6, 0)))
    assert launched == [width, 12]
    assert conv1d.causal_conv1d_plain(x, torch.zeros((6, width))).shape == x.shape


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
