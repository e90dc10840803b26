"""Where the port's scans form dt = softplus(delta + bias), on the CPU.

On the card a forward with no grad to take passes delta and the fp32 bias to
the scan kernel, which forms dt itself in fp32 and never rounds it; the grad
path, the stage form and every plain version on the CPU keep the JAX op's
``_prep`` contract (``_prep_dt``: dt formed in fp32, rounded to delta's
dtype). These tests hold the new form's plain version (``in_kernel_dt``,
``delta_dt``) to the existing plain path, to the oracle fed the unrounded dt
and to the JAX kernels (interpret mode), and show with a stand-in kernel
library which form each call takes and what the wrapper hands the kernel.
The kernels themselves are held to the plain version on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.ops.selective_scan import selective_scan as jscan
from aum_tpu.ops.selective_scan import selective_scan_dual as jscan_dual

import torch

ss = importlib.import_module("aum_tpu_torch.ops.selective_scan")  # the module, not the op

# Streams (u, delta, B, C, z) take the test dtype; A, D and the bias stay fp32.
_STREAMS = (0, 1, 3, 4, 6)


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


def _as_torch(args, dtype):
    return tuple(torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype) if i in _STREAMS else torch.float32) for i, a in enumerate(args))


def _as_jax(args, dtype):
    return tuple(jnp.asarray(a, dtype if i in _STREAMS else "float32")
                 for i, a in enumerate(args))


def _dual_args(shared, dtype, n=4):
    """Both directions' torch operands: v1 shares every tensor but A."""
    tf = _as_torch(_scan_args(10 + n, n=n), dtype)
    if shared:
        return tf, tf[:2] + (tf[2] * 0.5,) + tf[3:]
    return tf, _as_torch(_scan_args(20 + n, n=n), dtype)


def _unrounded_dt(delta, bias, softplus=True):
    """softplus(delta + bias) in fp32, written out as the JAX op's primitives."""
    v = delta.float() if bias is None else delta.float() + bias.float()
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs())) if softplus else v


# --- the plain version of the in-kernel dt -----------------------------------------

DUAL_CASES = {"v1": (True, False), "v2": (False, False), "v2_no_bias": (False, True)}


@pytest.mark.parametrize("case", sorted(DUAL_CASES))
def test_dual_plain_in_kernel_dt_is_the_prep_path_in_fp32(case):
    """In fp32 the unrounded dt is the rounded one: the new form's plain
    version gives the existing plain path's outputs bit for bit."""
    shared, no_bias = DUAL_CASES[case]
    fwd, rev = _dual_args(shared, "float32")
    if no_bias:
        fwd, rev = fwd[:7] + (None,), rev[:7] + (None,)
    got = ss.selective_scan_dual_plain(fwd, rev, in_kernel_dt=True)
    want = ss.selective_scan_dual_plain(*((a[0], ss._prep_dt(a[1], a[7])) + a[2:7]
                                          for a in (fwd, rev)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


SINGLE_CASES = {"forward": (False, True, True, False), "reverse": (True, True, True, False),
                "with_state": (False, True, True, True),
                "with_state_reverse": (True, True, True, True),
                "no_softplus": (False, False, True, False), "no_bias": (True, True, False, False)}


def _single_case(case, dtype):
    reverse, softplus, with_bias, with_state = SINGLE_CASES[case]
    args = _as_torch(_scan_args(40, d=32, n=16), dtype)
    if not softplus:  # delta is then the positive dt itself
        args = (args[0], args[1].abs()) + args[2:]
    if not with_bias:
        args = args[:7] + (None,)
    kw = {}
    if with_state:
        x0 = torch.from_numpy(np.random.default_rng(41).standard_normal((2, 32, 16))).float()
        kw = {"initial_state": x0, "return_final_state": True}
    return args, reverse, softplus, kw


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_single_plain_in_kernel_dt_is_the_prep_path_in_fp32(case):
    args, reverse, softplus, kw = _single_case(case, "float32")
    got = ss.selective_scan_plain(args, reverse, in_kernel_dt=True, softplus=softplus, **kw)
    want = ss.selective_scan_plain((args[0], ss._prep_dt(args[1], args[7], softplus))
                                   + args[2:7], reverse, **kw)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(DUAL_CASES))
def test_dual_plain_in_kernel_dt_keeps_dt_unrounded_in_bf16(case):
    """In bf16 the new form is the oracle on the fp32 dt, and not on the dt
    rounded to bf16 that the ``_prep`` contract streams."""
    shared, no_bias = DUAL_CASES[case]
    fwd, rev = _dual_args(shared, "bfloat16")
    if no_bias:
        fwd, rev = fwd[:7] + (None,), rev[:7] + (None,)
    got = ss.selective_scan_dual_plain(fwd, rev, in_kernel_dt=True)
    rounded = ss.selective_scan_dual_plain(*((a[0], ss._prep_dt(a[1], a[7])) + a[2:7]
                                             for a in (fwd, rev)))
    for y, r, a, reverse in zip(got, rounded, (fwd, rev), (False, True)):
        want = ss.selective_scan_ref(a[0], _unrounded_dt(a[1], a[7]), *a[2:6], z=a[6],
                                     reverse=reverse)
        assert y.dtype == torch.bfloat16 and torch.equal(y, want)
        assert not torch.equal(y, r)


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_single_plain_in_kernel_dt_keeps_dt_unrounded_in_bf16(case):
    args, reverse, softplus, kw = _single_case(case, "bfloat16")
    got = ss.selective_scan_plain(args, reverse, in_kernel_dt=True, softplus=softplus, **kw)
    want = ss.selective_scan_ref(args[0], _unrounded_dt(args[1], args[7], softplus),
                                 *args[2:6], z=args[6], reverse=reverse,
                                 initial_state=kw.get("initial_state"),
                                 return_last_state=bool(kw))
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert torch.equal(g, w)


# --- against the JAX kernels, whose dt is rounded to bf16 --------------------------

# max |err| / max |ref| between the unrounded-dt plain version and the JAX
# kernel on the bf16-rounded dt, as the fuse_dt form (also fp32 dt) is held.
JAX_TOL = 1e-2

_jscan_dual = jax.jit(functools.partial(jscan_dual, d_block=8, l_chunk=16))


def _scaled_err(got, want):
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    return np.abs(g - w).max() / np.abs(w).max()


@pytest.mark.parametrize("shared", [True, False], ids=["v1_shared", "v2_separate"])
def test_dual_in_kernel_dt_near_the_jax_kernel(shared):
    args_f = _scan_args(26, n=16)
    args_r = args_f[:2] + (args_f[2] * 0.5,) + args_f[3:] if shared else _scan_args(36, n=16)
    fwd, rev = _as_torch(args_f, "bfloat16"), _as_torch(args_r, "bfloat16")
    want = _jscan_dual(_as_jax(args_f, "bfloat16"), _as_jax(args_r, "bfloat16"))
    got = ss.selective_scan_dual_plain(fwd, rev, in_kernel_dt=True)
    for g, w in zip(got, want):
        assert _scaled_err(g, w) <= JAX_TOL


@pytest.mark.parametrize("case", ["forward", "reverse", "with_state"])
def test_single_in_kernel_dt_near_the_jax_kernel(case):
    args, reverse, softplus, kw = _single_case(case, "bfloat16")
    np_args = _scan_args(40, d=32, n=16)
    got = ss.selective_scan_plain(args, reverse, in_kernel_dt=True, softplus=softplus, **kw)
    jkw = {}
    if kw:
        jkw = {"initial_state": jnp.asarray(kw["initial_state"].numpy()),
               "return_final_state": True}
    ja = _as_jax(np_args, "bfloat16")
    want = jax.jit(lambda *a: jscan(*a[:6], z=a[6], delta_bias=a[7], delta_softplus=True,
                                    reverse=reverse, use_kernel=True, interpret=True,
                                    l_chunk=8, **jkw))(*ja)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert _scaled_err(g, w) <= JAX_TOL


# --- which form a call takes -----------------------------------------------------

class _StandIn:
    """A stand-in scan library: records each launch's entry and each
    direction's ScanDir fields, launches nothing."""

    def __init__(self):
        self.calls = []
        for entry in ("aum_selective_scan_dual_fwd", "aum_selective_scan_dual_direct_fwd",
                      "aum_selective_scan_dual_stage_fwd"):
            setattr(self, entry, functools.partial(self._dual, entry))

    def _fields(self, ref):
        p = ref._obj  # the structure ctypes.byref points at
        return {"dt": p.dt, "bias": p.bias, "xb": p.xb, "softplus": p.softplus}

    def _dual(self, entry, ref_f, ref_r, *rest):
        self.calls.append((entry, self._fields(ref_f), self._fields(ref_r)))
        return 0

    def aum_selective_scan_fwd(self, ref, *rest):
        self.calls.append(("aum_selective_scan_fwd", self._fields(ref)))
        return 0

    @staticmethod
    def aum_scan_error_string(status):
        return b""


@pytest.fixture
def stand_in(monkeypatch):
    """CPU tensors take the CUDA wrappers, which launch on the stand-in;
    ``_prep_dt``'s calls are counted."""
    lib = _StandIn()
    monkeypatch.setattr(ss, "_on_cpu", lambda t, what: False)
    monkeypatch.setattr(ss, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=None))
    prep = ss._prep_dt
    lib.preps = 0

    def counted(*a, **kw):
        lib.preps += 1
        return prep(*a, **kw)

    monkeypatch.setattr(ss, "_prep_dt", counted)
    for op, attr in ((ss.selective_scan_dual, "softplus_launches"),
                     (ss.selective_scan_dual, "launches"),
                     (ss.selective_scan, "softplus_launches"), (ss.selective_scan, "launches")):
        monkeypatch.setattr(op, attr, 0)
    for var in ("AUM_SCAN_DIRECT", "AUM_SCAN_BF16_STAGE", "AUM_SCAN_FUSE_DT"):
        monkeypatch.delenv(var, raising=False)
    return lib


@pytest.mark.parametrize("direct", [False, True], ids=["staged", "direct"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_dual_forms_dt_in_kernel_without_grad(stand_in, monkeypatch, grad, direct):
    """No grad: delta and the fp32 bias go to the kernel, no ``_prep_dt``.
    A grad: ``_prep_dt`` once (v1 shares delta), the rounded dt and saved
    states, as before."""
    if direct:
        monkeypatch.setenv("AUM_SCAN_DIRECT", "1")
    fwd, rev = _dual_args(True, "bfloat16")
    with torch.set_grad_enabled(grad):
        if grad:
            fwd = (fwd[0].requires_grad_(),) + fwd[1:]
            rev = (fwd[0],) + rev[1:]
        ss.selective_scan_dual(fwd, rev)
    entry = "aum_selective_scan_dual_direct_fwd" if direct else "aum_selective_scan_dual_fwd"
    ((called, f, r),) = stand_in.calls
    assert called == entry
    for p, a in ((f, fwd), (r, rev)):
        if grad:
            assert (p["softplus"], p["bias"], p["xb"] is not None) == (0, None, True)
            assert p["dt"] != a[1].data_ptr()
        else:
            assert (p["softplus"], p["xb"]) == (1, None)
            assert (p["dt"], p["bias"]) == (a[1].data_ptr(), a[7].data_ptr())
    assert stand_in.preps == (1 if grad else 0)
    assert ss.selective_scan_dual.softplus_launches == (0 if grad else 1)


def test_dual_stage_form_keeps_prep_dt(stand_in, monkeypatch):
    """The stage form (bf16 streams) streams the rounded dt with no grad too."""
    monkeypatch.setenv("AUM_SCAN_BF16_STAGE", "1")
    fwd, rev = _dual_args(False, "bfloat16")
    with torch.no_grad():
        ss.selective_scan_dual(fwd, rev)
    ((called, f, r),) = stand_in.calls
    assert called == "aum_selective_scan_dual_stage_fwd"
    assert (f["softplus"], f["bias"], r["softplus"], r["bias"]) == (0, None, 0, None)
    assert stand_in.preps == 2 and f["dt"] != fwd[1].data_ptr()
    assert ss.selective_scan_dual.softplus_launches == 0
    with pytest.raises(ValueError, match="in-kernel dt"):
        ss.selective_scan_dual_cuda(fwd, rev, in_kernel_dt=True)


@pytest.mark.parametrize("case", ["forward", "no_softplus", "no_bias", "with_state"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_single_forms_dt_in_kernel_without_grad(stand_in, grad, case):
    args, reverse, softplus, kw = _single_case(case, "bfloat16")
    with torch.set_grad_enabled(grad):
        if grad:
            args = (args[0].requires_grad_(),) + args[1:]
        ss.selective_scan(*args[:7], delta_bias=args[7], delta_softplus=softplus,
                          reverse=reverse, **kw)
    ((called, p),) = stand_in.calls
    assert called == "aum_selective_scan_fwd"
    if grad:
        assert (p["softplus"], p["bias"], p["xb"] is not None) == (0, None, True)
        assert p["dt"] != args[1].data_ptr() and stand_in.preps == 1
    else:
        bias = None if args[7] is None else args[7].data_ptr()
        assert (p["softplus"], p["xb"]) == (int(softplus), None)
        assert (p["dt"], p["bias"], stand_in.preps) == (args[1].data_ptr(), bias, 0)
    assert ss.selective_scan.softplus_launches == (0 if grad else 1)
    assert ss.selective_scan.launches == 1
    with pytest.raises(ValueError, match="in-kernel dt"):
        ss.selective_scan_cuda(args, reverse, save_states=True, in_kernel_dt=True)


def test_sliced_scans_form_dt_in_every_slice(stand_in, monkeypatch):
    """Above 16 states each slice's launch forms dt (the combine is stood in)."""
    monkeypatch.setattr(ss, "_sliced_lib", lambda: stand_in)
    monkeypatch.setattr(ss, "scan_combine_cuda",
                        lambda items: [torch.empty_like(it[1]) for it in items])
    args = _as_torch(_scan_args(50, d=8, n=20), "bfloat16")
    with torch.no_grad():
        ss.selective_scan(*args[:7], delta_bias=args[7], delta_softplus=True)
        ss.selective_scan_dual(args, args)
    assert [c[0] for c in stand_in.calls] == ["aum_selective_scan_fwd"] * 2 + [
        "aum_selective_scan_dual_fwd"] * 2
    assert all(p["softplus"] == 1 and p["dt"] == args[1].data_ptr()
               for c in stand_in.calls for p in c[1:])
    assert ss.selective_scan.softplus_launches == ss.selective_scan_dual.softplus_launches == 2
