"""The port's scan under ``aum_tpu``'s kernel switches, against the JAX package, on the CPU.

``AUM_SCAN_DIRECT=1`` makes the JAX dual scan's forward take
``_fwd_kernel_dual_direct`` and ``AUM_SCAN_BWD_FUSED=1`` its backward (and
the single-direction scan's) take ``_bwd_kernel_fused``; both run here in
Pallas interpret mode, as the JAX package's own tests run them, at its
tests' shapes (B=2, L=37, D=24, N=8, d_block 8, fp32) but with l_chunk 8
(an overhang chunk still: 37 = 4 * 8 + 5): the kernels' loops are unrolled
over l_chunk, and at 16 the interpret-mode compile takes 2.6 times as long
(10.6 against 4.0 s for the dual scan's forward and backward). On CPU
tensors the port's wrappers run the plain versions whatever the switches
(the kernels they choose among compute one function), so the same port
path is held to each JAX kernel. Also: the switches are parsed as JAX parses
them. Inputs are drawn with numpy from fixed seeds and handed to both
frameworks; torch is imported inside the tests, as in the other port test
modules.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

jss = importlib.import_module("aum_tpu.ops.selective_scan")  # the module, not the op

SWITCHES = ("AUM_SCAN_DIRECT", "AUM_SCAN_BWD_FUSED", "AUM_SCAN_DUAL_BWD")
SCAN_NAMES = ("u", "delta", "A", "B", "C", "D", "z", "bias")


def _torch(a):
    import torch

    return torch.from_numpy(np.array(a, np.float32))


def _scan_args(seed, bsz=2, seqlen=37, d=24, n=8):
    """(u, delta, A, B, C, D, z, delta_bias) as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bsz, seqlen, d)),
            rng.standard_normal((bsz, seqlen, d)) * 0.5,
            -np.exp(rng.standard_normal((d, n)) * 0.5),
            rng.standard_normal((bsz, seqlen, n)),
            rng.standard_normal((bsz, seqlen, n)),
            rng.standard_normal(d),
            rng.standard_normal((bsz, seqlen, d)),
            rng.standard_normal(d) * 0.1]


def _set_switches(monkeypatch, switches):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in switches.items():
        monkeypatch.setenv(name, value)


def _max_rel(got, want):
    """max |got - want| over max |want| (each tensor's own scale)."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


def test_dual_scan_matches_jax_switched_kernels(monkeypatch):
    """Under both switches, as the train path runs them: JAX's direct dual
    forward saves the states its fused backward (one pass per direction)
    restarts from. Bimamba v1 (the operands shared, A its own per
    direction): both outputs and all 16 grads of the JAX dual scan (v1's
    shared operands: the sum of the two directions' grads, as autograd sums
    them in the port) against the port's. Outputs within 2e-5, grads within
    2e-4 of each one's largest element (the bounds of the JAX package's own
    kernel tests)."""
    from aum_tpu_torch.ops import selective_scan_dual

    _set_switches(monkeypatch, {"AUM_SCAN_DIRECT": "1", "AUM_SCAN_BWD_FUSED": "1"})
    args = _scan_args(50)
    a_rev = args[2] * 0.5
    rng = np.random.default_rng(51)
    w_f, w_r = (rng.standard_normal(args[0].shape) for _ in range(2))

    def dual(*a):  # the 8 shared operands' leaves, then A_b
        return jss.selective_scan_dual(tuple(a[:8]), tuple(a[:2]) + (a[8],) + tuple(a[3:8]),
                                       d_block=8, l_chunk=8, interpret=True)

    def out_and_grads(jl, w):
        outs, vjp = jax.vjp(dual, *jl)
        return outs, vjp(w)

    # Jitted: the switches are read while it traces, as in a JAX program.
    (jy_f, jy_r), want = jax.jit(out_and_grads)(
        [jnp.asarray(a, jnp.float32) for a in args + [a_rev]],
        (jnp.asarray(w_f, jnp.float32), jnp.asarray(w_r, jnp.float32)))

    tl = [_torch(a).requires_grad_() for a in args + [a_rev]]
    y_f, y_r = selective_scan_dual(tuple(tl[:8]), tuple(tl[:2]) + (tl[8],) + tuple(tl[3:8]))
    for got, w in ((y_f, jy_f), (y_r, jy_r)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)
    ((y_f * _torch(w_f)).sum() + (y_r * _torch(w_r)).sum()).backward()
    for name, t, w in zip(SCAN_NAMES + ("A_b",), tl, want):
        assert _max_rel(t.grad, w) <= 2e-4, (name, _max_rel(t.grad, w))


def test_single_scan_grads_match_jax_fused_backward(monkeypatch):
    """All 8 grads of the single-direction scan against JAX's save_states
    ``_fwd_kernel_z`` + ``_bwd_kernel_fused`` (AUM_SCAN_BWD_FUSED=1), fp32,
    2e-4 of each grad's largest element (the dual test above runs the fused
    kernel reversed)."""
    from aum_tpu_torch.ops import selective_scan

    _set_switches(monkeypatch, {"AUM_SCAN_BWD_FUSED": "1"})
    args = _scan_args(52)
    w = np.random.default_rng(53).standard_normal(args[0].shape)

    def scan(*a):
        return jss.selective_scan(*a[:6], z=a[6], delta_bias=a[7], delta_softplus=True,
                                  use_kernel=True, interpret=True,
                                  d_block=8, l_chunk=8)

    def grads(a, w):
        return jax.vjp(scan, *a)[1](w)

    want = jax.jit(grads)([jnp.asarray(a, jnp.float32) for a in args],
                          jnp.asarray(w, jnp.float32))
    leaves = [_torch(a).requires_grad_() for a in args]
    y = selective_scan(*leaves[:7], delta_bias=leaves[7], delta_softplus=True)
    (y * _torch(w)).sum().backward()
    for name, t, g in zip(SCAN_NAMES, leaves, want):
        assert _max_rel(t.grad, g) <= 2e-4, (name, _max_rel(t.grad, g))


@pytest.mark.parametrize("value", [None, "", "0", "1"], ids=["unset", "empty", "0", "1"])
def test_switches_parse_as_jax(value, monkeypatch):
    """Each switch reads as ``aum_tpu``'s ``_env_int``: unset or empty is the
    default (off), otherwise the integer; AUM_SCAN_DUAL_BWD=1 keeps the dual
    scan's backward on the interleaved-directions kernel (K2 with both
    directions) whatever AUM_SCAN_BWD_FUSED says, and leaves the
    single-direction backward to it."""
    ss_mod = importlib.import_module("aum_tpu_torch.ops.selective_scan")
    for name in SWITCHES:
        _set_switches(monkeypatch, {} if value is None else {name: value})
        assert ss_mod._env_int(name, 0) == jss._env_int(name, 0)
    on = value == "1"
    _set_switches(monkeypatch, {} if value is None else {"AUM_SCAN_DIRECT": value})
    assert ss_mod.direct_forward_chosen() is on
    _set_switches(monkeypatch, {} if value is None else {"AUM_SCAN_BWD_FUSED": value})
    assert ss_mod.fused_backward_chosen(1) is on and ss_mod.fused_backward_chosen(2) is on
    monkeypatch.setenv("AUM_SCAN_DUAL_BWD", "1")
    assert ss_mod.fused_backward_chosen(1) is on and not ss_mod.fused_backward_chosen(2)
