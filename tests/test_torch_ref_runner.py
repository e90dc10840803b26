"""The PyTorch port's upstream-code runner (``aum_tpu_torch/convert/ref_runner.py``)
against the JAX package's (``aum_tpu/convert/ref_runner.py``), on the CPU.

- Each oracle against the same-named one of the JAX package's module,
  built by each module's ``_build_oracle_modules`` (not through
  ``sys.modules``, which both modules fill under the same names), in fp32 and
  bf16: outputs and input grads ``torch.equal`` (the port's copy keeps the
  op order).
- The oracles against the port's plain scan and conv and against
  ``aum_tpu/ops/scan_ref.py`` (under ``jax.value_and_grad``), with the grads,
  within the bounds ``chip_smoke.py`` holds the kernels to (fp32 scan 1e-4 /
  1e-4, conv 1e-5 / 1e-5, bf16 1e-2 / 1e-2; grads 1e-4 or 1e-2 of the
  largest); ``return_last_state`` against the port's with_state scan; the
  add+RMSNorm oracle against the port's ``fused_add_norm``; the upstream
  mixer's fast path through the oracles (``oracle_mixer_forward``) against
  the port's ``MambaMixer``, Fo-Fo, Fo-Bi and Bi-Bi, forward and the grads of
  the input and every weight.
- ``install_reference_stubs`` twice (idempotent) inside a snapshot of
  ``sys.modules`` and ``sys.path`` that is then restored, and
  ``import_reference_models`` / ``import_reference_lm`` against a fake
  upstream tree written under ``tmp_path`` (``AUM_REFERENCE_PATH`` is read
  at every call), each file importing the stubbed modules.

Sizes: B=2, L=45, D=32, N=8. torch is imported inside the tests.
"""

import contextlib
import importlib.util
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.convert import ref_runner as jax_rr
from aum_tpu.ops.scan_ref import selective_scan_ref as jax_scan_ref

BSZ, L, D, N, K = 2, 45, 32, 8, 4
SCAN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}  # (atol, rtol)
CONV_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}  # max |err| over max |ref|
STUBBED = ("timm", "timm.models", "timm.models.layers", "wget", "causal_conv1d",
           "mamba_ssm.ops.selective_scan_interface", "mamba_ssm.ops.triton.layernorm",
           "mamba_ssm.ops.triton.selective_state_update")


@contextlib.contextmanager
def restored_modules():
    """Put ``sys.modules`` and ``sys.path`` back as they were on exit: the
    stubs (a ``timm`` with a spec that ``importlib.util.find_spec`` finds)
    and a fake tree's modules must not leak into later tests of the worker."""
    modules, path = dict(sys.modules), list(sys.path)
    try:
        yield
    finally:
        for name in set(sys.modules) - set(modules):
            del sys.modules[name]
        sys.modules.update(modules)
        sys.path[:] = path


def _oracles():
    from aum_tpu_torch.convert import ref_runner

    return ref_runner._build_oracle_modules(), jax_rr._build_oracle_modules()


def _rng_tensor(rng, shape, dtype, scale=1.0, grad=True):
    import torch

    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)
    return t.requires_grad_(grad)


def _scan_inputs(dtype, seed=0):
    """Upstream layouts: u, delta, z (B, D, L); A (D, N); B, C (B, N, L)."""
    import torch

    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return dict(
        u=_rng_tensor(rng, (BSZ, D, L), dt), delta=_rng_tensor(rng, (BSZ, D, L), dt, 0.5),
        A=(-torch.exp(_rng_tensor(rng, (D, N), torch.float32, 0.5, grad=False))
           ).requires_grad_(),
        B=_rng_tensor(rng, (BSZ, N, L), dt), C=_rng_tensor(rng, (BSZ, N, L), dt),
        D=_rng_tensor(rng, (D,), torch.float32), z=_rng_tensor(rng, (BSZ, D, L), dt),
        delta_bias=_rng_tensor(rng, (D,), torch.float32, 0.5))


def _mixer_params(bimamba_type, dtype, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    d_model, d_in = D // 2, D
    rank = 1
    p = {"in_proj.weight": (2 * d_in, d_model), "out_proj.weight": (d_model, d_in),
         "A_log": (d_in, N), "D": (d_in,)}
    for s in ("", "_b") if bimamba_type == "v2" else ("",):
        p.update({f"conv1d{s}.weight": (d_in, 1, K), f"conv1d{s}.bias": (d_in,),
                  f"x_proj{s}.weight": (rank + 2 * N, d_in),
                  f"dt_proj{s}.weight": (d_in, rank), f"dt_proj{s}.bias": (d_in,)})
    if bimamba_type == "v2":
        p["D_b"] = (d_in,)
    if bimamba_type != "none":
        p["A_b_log"] = (d_in, N)
    return {k: _rng_tensor(rng, s, torch.float32, 0.3) for k, s in p.items()}


def _call(name, o, dtype, seed=0):
    """Run oracle ``name`` of the oracle dict ``o`` on seeded inputs: (outputs,
    the leaf inputs whose grads are taken)."""
    import torch

    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    if name == "causal_conv1d_fn":
        leaves = [_rng_tensor(rng, (BSZ, D, L), dt), _rng_tensor(rng, (D, K), dt),
                  _rng_tensor(rng, (D,), dt)]
        return [o[name](*leaves, activation="silu")], leaves
    if name == "causal_conv1d_update":
        x, w, b = (_rng_tensor(rng, (BSZ, D), dt), _rng_tensor(rng, (D, K), dt),
                   _rng_tensor(rng, (D,), dt))
        state = _rng_tensor(rng, (BSZ, D, K), dt, grad=False)
        return [o[name](x, state, w, b, activation="silu"), state], [x, w, b]
    if name == "selective_scan_fn":
        a = _scan_inputs(dtype, seed)
        y, last = o[name](a["u"], a["delta"], a["A"], a["B"], a["C"], a["D"], z=a["z"],
                          delta_bias=a["delta_bias"], delta_softplus=True,
                          return_last_state=True)
        return [y, last], list(a.values())
    if name in ("mamba_inner_fn", "mamba_inner_fn_no_out_proj", "bimamba_inner_fn"):
        bt = {"mamba_inner_fn": "none", "mamba_inner_fn_no_out_proj": "none",
              "bimamba_inner_fn": "v1"}[name]
        p = _mixer_params(bt, dtype, seed)
        xz = _rng_tensor(rng, (BSZ, 2 * D, L), dt)
        A = -torch.exp(p["A_log"])
        w = [p[k].to(dt) for k in ("conv1d.weight", "conv1d.bias", "x_proj.weight",
                                   "dt_proj.weight")]
        kw = dict(D=p["D"], delta_bias=p["dt_proj.bias"], delta_softplus=True)
        out_w = p["out_proj.weight"].to(dt)
        if name == "mamba_inner_fn_no_out_proj":
            out = o[name](xz, *w, A, None, None, **kw)
        elif name == "mamba_inner_fn":
            out = o[name](xz, *w, out_w, None, A, None, None, **kw)
        else:
            out = o[name](xz, *w, out_w, None, A, -torch.exp(p["A_b_log"]), None, None, **kw)
        return [out], [xz, *p.values()]
    if name in ("layer_norm_fn", "rms_norm_fn", "RMSNorm"):
        # The residual stream is fp32, as the blocks carry it.
        x, res = _rng_tensor(rng, (BSZ, L, D), dt), _rng_tensor(rng, (BSZ, L, D), torch.float32)
        w = _rng_tensor(rng, (D,), torch.float32)
        if name == "layer_norm_fn":
            b = _rng_tensor(rng, (D,), torch.float32)
            out = o[name](x, w, b, residual=res, eps=1e-5, prenorm=True, residual_in_fp32=True)
            return list(out), [x, res, w, b]
        if name == "rms_norm_fn":
            out = o[name](x, w, None, residual=res, eps=1e-5, prenorm=True,
                          residual_in_fp32=True)
            return list(out), [x, res, w]
        norm = o[name](D, eps=1e-5)
        with torch.no_grad():
            norm.weight.copy_(w)
        return list(norm(x, residual=res, prenorm=True)), [x, res, norm.weight]
    raise KeyError(name)


ORACLES = ("causal_conv1d_fn", "causal_conv1d_update", "selective_scan_fn", "mamba_inner_fn",
           "mamba_inner_fn_no_out_proj", "bimamba_inner_fn", "layer_norm_fn", "rms_norm_fn",
           "RMSNorm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ORACLES)
def test_oracle_equals_the_jax_package_oracle(name, dtype):
    """Both modules' oracle on the same inputs: outputs and the grads of the
    inputs equal bit for bit."""
    import torch

    port, jax_side = _oracles()
    assert set(port) == set(jax_side) == set(ORACLES)
    results = []
    for o in (port, jax_side):
        outs, leaves = _call(name, o, dtype)
        loss = sum((out.float() * (i + 1)).sum() for i, out in enumerate(outs)
                   if out.requires_grad)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        results.append((outs, grads))
    (outs_p, grads_p), (outs_j, grads_j) = results
    for a, b in zip(outs_p, outs_j):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(grads_p, grads_j):
        assert (a is None and b is None) or torch.equal(a, b)


def _scaled_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _to_blD(t):
    """Upstream (B, D, L) or (B, N, L) -> the port's (B, L, D)."""
    return t.transpose(1, 2).detach().clone().requires_grad_(t.requires_grad)


def _activated_dt(a):
    """bf16 inputs with dt activated outside the scan and rounded to bf16,
    as the port's and the JAX package's scans take it (``_prep_dt``): the
    upstream kernel keeps softplus(delta + bias) in fp32, so with the
    softplus inside, a bf16 y differs by that rounding (a few elements of
    2880 past 1e-2 + 1e-2 |y|); fed the same dt, the two compute one
    function."""
    import torch
    import torch.nn.functional as F

    dt = F.softplus(a["delta"].detach().float() + a["delta_bias"].detach()[None, :, None])
    a = dict(a, delta=dt.to(torch.bfloat16).requires_grad_())
    del a["delta_bias"]
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_oracle_matches_the_port_and_scan_ref(dtype):
    """selective_scan_fn (with its last state) against the port's
    ``selective_scan`` with ``return_final_state`` (its plain with_state form
    on the CPU) and against ``aum_tpu.ops.scan_ref``: y, the last state and
    the grads of every input. fp32 with the softplus and dt bias inside the
    scan; bf16 with dt activated outside (``_activated_dt``)."""
    import torch

    from aum_tpu_torch.convert import ref_runner
    from aum_tpu_torch.ops import selective_scan

    a = _scan_inputs(dtype)
    softplus = dtype == "float32"
    if not softplus:
        a = _activated_dt(a)
    o = ref_runner._build_oracle_modules()

    def scan(fn, v, **kw):
        return fn(v["u"], v["delta"], v["A"], v["B"], v["C"], v["D"], z=v["z"],
                  delta_bias=v.get("delta_bias"), delta_softplus=softplus, **kw)

    y, last = scan(o["selective_scan_fn"], a, return_last_state=True)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(y.shape).astype(np.float32))
    want_grads = torch.autograd.grad((y.float() * g).sum() + last.sum(), list(a.values()))

    p = {k: (_to_blD(v) if v.dim() == 3 else v.detach().clone().requires_grad_())
         for k, v in a.items()}
    y_p, last_p = scan(selective_scan, p, return_final_state=True)
    got_grads = torch.autograd.grad((y_p.float() * g.transpose(1, 2)).sum() + last_p.sum(),
                                    list(p.values()))
    atol, rtol = SCAN_TOL[dtype]
    np.testing.assert_allclose(y_p.transpose(1, 2).float().detach().numpy(),
                               y.float().detach().numpy(), atol=atol, rtol=rtol)
    np.testing.assert_allclose(last_p.detach().numpy(), last.detach().numpy(),
                               atol=SCAN_TOL["float32"][0], rtol=SCAN_TOL["float32"][1])
    for name, got, want in zip(a, got_grads, want_grads):
        got = got.transpose(1, 2) if got.dim() == 3 else got
        assert _scaled_err(got, want) <= GRAD_TOL[dtype], name

    # aum_tpu/ops/scan_ref.py, the JAX package's plain reference, in fp32 on
    # the same (bf16-valued) inputs.
    ja = {k: jnp.asarray((_to_blD(v) if v.dim() == 3 else v).detach().float().numpy())
          for k, v in a.items()}

    def loss(ja):
        yj, lastj = jax_scan_ref(ja["u"], ja["delta"], ja["A"], ja["B"], ja["C"], ja["D"],
                                 ja["z"], ja.get("delta_bias"), delta_softplus=softplus,
                                 return_last_state=True)
        return (yj * jnp.asarray(g.transpose(1, 2).numpy())).sum() + lastj.sum(), (yj, lastj)

    (_, (yj, lastj)), jgrads = jax.value_and_grad(loss, has_aux=True)(ja)
    np.testing.assert_allclose(y.float().transpose(1, 2).detach().numpy(), np.asarray(yj),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(last.detach().numpy(), np.asarray(lastj),
                               atol=SCAN_TOL["float32"][0], rtol=SCAN_TOL["float32"][1])
    for name, want in zip(a, want_grads):
        jg = torch.from_numpy(np.array(jgrads[name]))
        jg = jg.transpose(1, 2) if jg.dim() == 3 else jg
        assert _scaled_err(want, jg) <= GRAD_TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_oracle_matches_the_port_conv(dtype):
    """causal_conv1d_fn (SiLU) against the port's ``causal_conv1d`` (its
    plain version on the CPU): output and the grads of x, weight, bias."""
    import torch

    from aum_tpu_torch.ops import causal_conv1d

    o, _ = _oracles()
    (out,), leaves = _call("causal_conv1d_fn", o, dtype)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(out.shape).astype(np.float32))
    want = torch.autograd.grad((out.float() * g).sum(), leaves)
    x, w, b = [t.detach().clone().requires_grad_() for t in leaves]
    got_out = causal_conv1d(x.transpose(1, 2), w, b, activation="silu")
    got = torch.autograd.grad((got_out.float() * g.transpose(1, 2)).sum(), [x, w, b])
    atol, rtol = CONV_TOL[dtype]
    np.testing.assert_allclose(got_out.transpose(1, 2).float().detach().numpy(),
                               out.float().detach().numpy(), atol=atol, rtol=rtol)
    for name, a, b_ in zip(("dx", "dw", "db"), got, want):
        assert _scaled_err(a, b_) <= GRAD_TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_oracle_matches_fused_add_norm(dtype):
    """rms_norm_fn(prenorm=True, residual_in_fp32=True) against the block's
    add+RMSNorm (``ops.fused_add_norm``): the normalized output and the fp32
    residual."""
    import torch

    from aum_tpu_torch.ops import fused_add_norm

    o, _ = _oracles()
    (y, res), (x, residual, w) = _call("rms_norm_fn", o, dtype)
    got_y, got_res = fused_add_norm(x, w.to(x.dtype), residual=residual, prenorm=True,
                                    eps=1e-5, residual_in_fp32=True)
    assert got_res.dtype == res.dtype == torch.float32 and got_y.dtype == y.dtype
    atol, rtol = SCAN_TOL[dtype]
    np.testing.assert_allclose(got_res.detach().numpy(), res.detach().numpy(), atol=0, rtol=0)
    np.testing.assert_allclose(got_y.float().detach().numpy(), y.float().detach().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bimamba_type", ["none", "v1", "v2"])
def test_oracle_mixer_matches_the_port_mixer(bimamba_type, dtype):
    """The upstream mixer's fast path through the oracles (Fo-Fo
    ``mamba_inner_fn``, Fo-Bi ``bimamba_inner_fn``, Bi-Bi two
    ``mamba_inner_fn_no_out_proj``) against the port's ``MambaMixer`` on the
    same weights: the output and the grads of the input and of every weight.
    In bf16 the two pipelines round at other places (the port rounds dt to
    bf16 as the JAX package does) and the upstream's own bf16 grads lie 1-2%
    of max-abs from its fp32 ones, so the port's bf16 grads are held to the
    oracle's fp32 grads within 1e-2 of max-abs or twice the oracle's own
    worst bf16 error, the larger (as ``chip_smoke.py``'s ref_oracles phase
    holds them: ``REF_BF16_GRAD_RATIO``)."""
    import torch

    from aum_tpu_torch.convert.ref_runner import oracle_mixer_forward
    from aum_tpu_torch.models.mamba import MambaMixer

    dt = getattr(torch, dtype)
    mixer = MambaMixer(D // 2, d_state=N, bimamba_type=bimamba_type, n_layer=2)
    mixer.reset_parameters(torch.Generator().manual_seed(3))
    params = dict(mixer.named_parameters())
    x = _rng_tensor(np.random.default_rng(5), (BSZ, L, D // 2), dt, grad=False)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(x.shape).astype(np.float32))
    with torch.no_grad():
        got, want = mixer(x), oracle_mixer_forward(params, x, bimamba_type)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=SCAN_TOL[dtype][0], rtol=SCAN_TOL[dtype][1])

    def grads(fn, x_dtype):
        ps = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        xr = x.to(x_dtype).requires_grad_()
        return torch.autograd.grad((fn(ps, xr).float() * g).sum(), [xr, *ps.values()])

    port = grads(lambda ps, xr: torch.func.functional_call(mixer, ps, (xr,)), dt)
    oracle = grads(lambda ps, xr: oracle_mixer_forward(ps, xr, bimamba_type), dt)
    names = ["x", *params]
    if dtype == "float32":
        for name, a, b in zip(names, port, oracle):
            assert _scaled_err(a, b) <= GRAD_TOL[dtype], name
        return
    exact = grads(lambda ps, xr: oracle_mixer_forward(ps, xr, bimamba_type), torch.float32)
    allowed = max(GRAD_TOL[dtype], 2.0 * max(_scaled_err(a, b) for a, b in zip(oracle, exact)))
    for name, a, b in zip(names, port, exact):
        assert _scaled_err(a, b) <= allowed, name


def test_oracles_call_nothing_of_the_port_ops():
    """The parity the oracles give means something only if they are written
    without the port's ops: the module imports nothing of
    ``aum_tpu_torch.ops``, of this package at all, or of the JAX package."""
    import ast
    import inspect

    from aum_tpu_torch.convert import ref_runner

    imported = set()
    for node in ast.walk(ast.parse(inspect.getsource(ref_runner))):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module)
    assert imported == {"__future__", "os", "sys", "types", "importlib", "importlib.machinery",
                        "torch", "torch.nn.functional"}, imported


def test_install_reference_stubs_is_idempotent_and_restored():
    from aum_tpu_torch.convert import ref_runner

    before_modules, before_path = set(sys.modules), list(sys.path)
    timm_spec = importlib.util.find_spec("timm") if "timm" not in sys.modules else None
    with restored_modules():
        ref_runner.install_reference_stubs()
        first = {name: sys.modules[name] for name in STUBBED}
        iface = first["mamba_ssm.ops.selective_scan_interface"]
        fns = {k: getattr(iface, k) for k in ("selective_scan_fn", "mamba_inner_fn",
                                              "bimamba_inner_fn", "mamba_inner_fn_no_out_proj")}
        assert getattr(iface, ref_runner.ORACLE_MARKER) is True
        assert importlib.util.find_spec("timm") is not None  # the stub has a spec
        ref_runner.install_reference_stubs()
        assert all(sys.modules[name] is mod for name, mod in first.items())
        assert all(getattr(iface, k) is f for k, f in fns.items())
        assert sys.modules["mamba_ssm.ops.triton.selective_state_update"] \
            .selective_state_update is None
        with pytest.raises(RuntimeError, match="downloads disabled"):
            sys.modules["wget"].download("x")
    assert set(sys.modules) == before_modules and sys.path == before_path
    if "timm" not in sys.modules:
        assert importlib.util.find_spec("timm") == timm_spec


FAKE_MODELS = '''
from timm.models.layers import DropPath, lecun_normal_, to_2tuple, trunc_normal_
import wget
try:
    from causal_conv1d import causal_conv1d_fn
except ImportError:
    causal_conv1d_fn = None
try:
    from mamba_ssm.ops.selective_scan_interface import (
        bimamba_inner_fn, mamba_inner_fn, mamba_inner_fn_no_out_proj, selective_scan_fn)
except ImportError:
    bimamba_inner_fn = mamba_inner_fn = mamba_inner_fn_no_out_proj = None
try:
    from mamba_ssm.ops.triton.layernorm import RMSNorm, layer_norm_fn, rms_norm_fn
except ImportError:
    RMSNorm, layer_norm_fn, rms_norm_fn = None, None, None


class AudioMamba:
    def __init__(self, **kw):
        self.kw = kw
'''

FAKE_LM = '''
from mamba_ssm.ops.selective_scan_interface import mamba_inner_fn, selective_scan_fn
from mamba_ssm.ops.triton.layernorm import RMSNorm, layer_norm_fn, rms_norm_fn


class MambaLMHeadModel:
    pass
'''


def test_import_reference_against_a_fake_tree(tmp_path, monkeypatch):
    """``import_reference_models`` and ``import_reference_lm`` against an
    upstream tree written under ``tmp_path``, pointed at through
    ``AUM_REFERENCE_PATH`` after import: each file binds the oracles and
    stubs; without a tree both raise."""
    from aum_tpu_torch.convert import ref_runner

    monkeypatch.setenv("AUM_REFERENCE_PATH", str(tmp_path / "absent"))
    assert not ref_runner.reference_available()
    with pytest.raises(RuntimeError, match="reference not found"):
        ref_runner.import_reference_models()

    root = tmp_path / "upstream"
    (root / "src" / "models").mkdir(parents=True)
    for f in ("src/__init__.py", "src/models/__init__.py"):
        (root / f).write_text("")
    (root / "src" / "models" / "mamba_models.py").write_text(FAKE_MODELS)
    pkg = root / "vim-mamba_ssm" / "mamba_ssm"
    (pkg / "models").mkdir(parents=True)
    (pkg / "ops").mkdir()
    for f in ("__init__.py", "models/__init__.py", "ops/__init__.py"):
        (pkg / f).write_text("")
    (pkg / "models" / "mixer_seq_simple.py").write_text(FAKE_LM)
    monkeypatch.setenv("AUM_REFERENCE_PATH", str(root))
    assert ref_runner.reference_root() == str(root) and ref_runner.reference_available()
    with restored_modules():
        mm = ref_runner.import_reference_models()
        iface = sys.modules["mamba_ssm.ops.selective_scan_interface"]
        assert mm.__file__ == str(root / "src" / "models" / "mamba_models.py")
        assert mm.bimamba_inner_fn is iface.bimamba_inner_fn
        assert mm.mamba_inner_fn_no_out_proj is iface.mamba_inner_fn_no_out_proj
        assert mm.causal_conv1d_fn is sys.modules["causal_conv1d"].causal_conv1d_fn
        assert mm.rms_norm_fn is sys.modules["mamba_ssm.ops.triton.layernorm"].rms_norm_fn
        assert mm.to_2tuple(3) == (3, 3) and mm.AudioMamba(depth=2).kw == {"depth": 2}
        assert str(root) in sys.path and str(root / "vim-mamba_ssm") in sys.path
        lm = ref_runner.import_reference_lm()
        assert lm.__file__ == str(pkg / "models" / "mixer_seq_simple.py")
        assert lm.selective_scan_fn is iface.selective_scan_fn
        assert hasattr(lm, "MambaLMHeadModel")
    assert "src.models.mamba_models" not in sys.modules
    assert str(root) not in sys.path
