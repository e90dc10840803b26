"""The port's scan under ``aum_tpu``'s four opt-in forms, against the JAX package, on the CPU.

The forms: ``AUM_SCAN_FUSE_DT=1`` (the dual scan's dt_proj product folded
into ``_fwd_kernel_dual``: ``selective_scan_dual(dt_fold=)``, and the
bimamba mixers passing it), ``AUM_SCAN_BF16_STAGE=1`` (the dual forward's
bf16 staging), ``AUM_SCAN_BWD_BF16_PARTIALS=1`` (bf16 dB/dC partials in the
backward kernels) and ``AUM_SCAN_BWD_XMINUS=1`` / ``AUM_SCAN_BWD_DBU=1``
(``_bwd_kernel``'s dla modes). The JAX side runs its Pallas kernels in
interpret mode, jitted (the switches are read while it traces), at
``tests/test_torch_scan_forms.py``'s shapes: B=2, L=37, D=24, N=8, dt rank
6, fp32, d_block 8, l_chunk 8. On CPU tensors the port's wrappers run the
plain version of the form the switches choose. Inputs are drawn with numpy
from fixed seeds and handed to both frameworks; torch is imported inside the
tests, as in the other port test modules. Tolerances are the JAX package's
own for each form (``tests/test_selective_scan.py``, ``tests/test_model.py``).
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

jss = importlib.import_module("aum_tpu.ops.selective_scan")  # the module, not the op

SWITCHES = ("AUM_SCAN_DIRECT", "AUM_SCAN_BWD_FUSED", "AUM_SCAN_DUAL_BWD", "AUM_SCAN_FUSE_DT",
            "AUM_SCAN_BF16_STAGE", "AUM_SCAN_BWD_BF16_PARTIALS", "AUM_SCAN_BWD_XMINUS",
            "AUM_SCAN_BWD_DBU")
FOLD_NAMES = ("u", "dtr", "W", "A", "B", "C", "D", "z", "bias")
SCAN_NAMES = ("u", "delta", "A", "B", "C", "D", "z", "bias")
KW = dict(d_block=8, l_chunk=8, interpret=True)


def _torch(a, dtype="float32"):
    import torch

    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def _np(t):
    return t.detach().float().numpy()


def _set_switches(monkeypatch, switches):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in switches.items():
        monkeypatch.setenv(name, value)


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
            rng.standard_normal(d) * 0.3]


def _fold_args(seed, bsz=2, seqlen=37, d=24, n=8, rank=6):
    """(u, dtr, W, A, B, C, D, z, delta_bias) as fp32 numpy arrays: dtr (B,
    L, R) and W (R, D) in delta's place, scaled as the JAX package's fold
    tests scale them."""
    rng = np.random.default_rng(seed)
    u, _, A, B, C, D, z, bias = _scan_args(seed, bsz, seqlen, d, n)
    return [u, rng.standard_normal((bsz, seqlen, rank)) * 0.5,
            rng.standard_normal((rank, d)) * 0.4, A, B, C, D, z, bias]


def _fold_dirs(fold_f, fold_r):
    """(args_fwd, args_rev, dt_fold) of the dual scan from two 9-tuples."""
    def args(f):
        return (f[0], None) + tuple(f[3:])

    return args(fold_f), args(fold_r), ((fold_f[1], fold_f[2]), (fold_r[1], fold_r[2]))


def _fold_inputs(shared, seed, rank=6):
    """Both directions' 9-tuples: v1 passes the same tensors (A_b its own),
    v2 its own dtr, W, A and bias."""
    fold_f = _fold_args(seed, rank=rank)
    if shared:
        return fold_f, fold_f[:3] + [fold_f[3] * 0.7] + fold_f[4:]
    other = _fold_args(seed + 1, rank=rank)
    return fold_f, fold_f[:1] + other[1:4] + fold_f[4:8] + other[8:]


def _fold_leaves(shared, seed, rank=6):
    """The leaves of both directions: the first direction's 9, then for v1
    A_b, for v2 the second direction's dtr, W, A and bias."""
    fold_f, fold_r = _fold_inputs(shared, seed, rank)
    return list(fold_f) + ([fold_r[3]] if shared else [fold_r[1], fold_r[2], fold_r[3],
                                                       fold_r[8]])


def _fold_call(leaves, shared):
    """(args_fwd, args_rev, dt_fold) of the dual scan from ``_fold_leaves``'
    leaves (numpy, JAX or torch), v1's shared tensors passed twice."""
    fold_f = tuple(leaves[:9])
    if shared:
        fold_r = fold_f[:3] + (leaves[9],) + fold_f[4:]
    else:
        fold_r = (fold_f[0],) + tuple(leaves[9:12]) + fold_f[4:8] + (leaves[12],)
    return _fold_dirs(fold_f, fold_r)


def _jax_fold_dual(leaves, shared):
    args_f, args_r, fold = _fold_call(leaves, shared)
    return jss.selective_scan_dual(args_f, args_r, dt_fold=fold, **KW)


@functools.cache
def _jax_fold_dual_jit(shared):
    """The JAX fuse_dt forward, jitted once per form (it retraces per shape)."""
    return jax.jit(lambda ls: _jax_fold_dual(ls, shared))


def _port_fold_dual(leaves, shared):
    from aum_tpu_torch.ops import selective_scan_dual

    args_f, args_r, fold = _fold_call(leaves, shared)
    return selective_scan_dual(args_f, args_r, dt_fold=fold)


@pytest.mark.parametrize("shared", [True, False], ids=["v1", "v2"])
def test_fuse_dt_forward_matches_jax_kernel(shared, monkeypatch):
    """The eval form: JAX's ``_fwd_kernel_dual`` with the product in the
    kernel (``_get_dual_fdt_op``) against the port's plain version of the
    fuse_dt kernel (fp32 dt, never rounded), both outputs within 2e-5 (the
    JAX package's own bound for this kernel against its oracle)."""
    import torch

    _set_switches(monkeypatch, {"AUM_SCAN_FUSE_DT": "1"})
    leaves = _fold_leaves(shared, 60)
    want = _jax_fold_dual_jit(shared)([jnp.asarray(a, jnp.float32) for a in leaves])
    with torch.no_grad():
        got = _port_fold_dual([_torch(a) for a in leaves], shared)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("rank", [1, 17, 64])
def test_fuse_dt_forward_matches_jax_kernel_at_ranks(rank, monkeypatch):
    """The fuse_dt forward at the dt ranks whose kernel edges the card checks
    (``chip_smoke.py`` ``_check_edges``): one partial k-step of the
    tensor-core product, one past a whole one, and the largest the kernel
    takes; v1, the port's plain version against JAX's kernel within the same
    2e-5."""
    import torch

    _set_switches(monkeypatch, {"AUM_SCAN_FUSE_DT": "1"})
    leaves = _fold_leaves(True, 61, rank)
    want = _jax_fold_dual_jit(True)([jnp.asarray(a, jnp.float32) for a in leaves])
    with torch.no_grad():
        got = _port_fold_dual([_torch(a) for a in leaves], True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shared", [True, False], ids=["v1", "v2"])
def test_fuse_dt_grads_match_jax(shared, monkeypatch):
    """Under autograd: ``_make_dual_scan_fdt``'s rules (delta = dtr @ W
    outside the kernel, the staged saving forward, the dual backward, then
    the product's grads in fp32) against ``_DualScanFold``: the outputs and
    every grad, dtr and W included (v1: the 9 shared leaves and A_b; v2: 13
    leaves), within 3e-4 (the JAX package's bound for these grads)."""
    _set_switches(monkeypatch, {"AUM_SCAN_FUSE_DT": "1"})
    leaves = _fold_leaves(shared, 62)
    rng = np.random.default_rng(63)
    w_f, w_r = (rng.standard_normal(leaves[0].shape) for _ in range(2))

    def out_and_grads(ls, cot):
        outs, vjp = jax.vjp(lambda *a: _jax_fold_dual(a, shared), *ls)
        return outs, vjp(cot)

    (jy_f, jy_r), want = jax.jit(out_and_grads)(
        [jnp.asarray(a, jnp.float32) for a in leaves],
        (jnp.asarray(w_f, jnp.float32), jnp.asarray(w_r, jnp.float32)))
    tl = [_torch(a).requires_grad_() for a in leaves]
    y_f, y_r = _port_fold_dual(tl, shared)
    for got, w in ((y_f, jy_f), (y_r, jy_r)):
        np.testing.assert_allclose(_np(got), np.asarray(w), rtol=2e-5, atol=2e-5)
    ((y_f * _torch(w_f)).sum() + (y_r * _torch(w_r)).sum()).backward()
    names = FOLD_NAMES + (("A_b",) if shared else ("dtr_b", "W_b", "A_b", "bias_b"))
    for name, t, w in zip(names, tl, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=3e-4, atol=3e-4,
                                   err_msg=name)


def test_fuse_dt_model_matches_jax(monkeypatch):
    """A depth-2 tiny Fo-Bi model (v1, embed 128, d_state 8, 9 tokens) under
    AUM_SCAN_FUSE_DT=1, the port's weights carried into the JAX model by
    its porter: the logits of the eval forward (JAX: the fuse_dt kernel; the
    port: its plain version) within 2e-5, and the grads of every layer's
    x_proj and dt_proj weights (the fold's product rule) within 3e-4 / 3e-5
    (rtol / atol: ``tests/test_model.py``'s bounds for the fold)."""
    import torch

    from aum_tpu.convert.torch_port import port_aum_state_dict
    from aum_tpu.models import AudioMamba as JaxAudioMamba
    from aum_tpu.models import AudioMambaConfig as JaxConfig
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    _set_switches(monkeypatch, {"AUM_SCAN_FUSE_DT": "1"})
    kw = dict(spectrogram_size=(32, 64), depth=2, embed_dim=128, d_state=8, num_classes=5,
              bimamba_type="v1", remat=False)
    model = AudioMamba(AudioMambaConfig(**kw), device="cpu", seed=31)
    jcfg = JaxConfig(**kw)
    jmodel = JaxAudioMamba(jcfg, use_kernel=True)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = jax.tree.map(jnp.asarray, port_aum_state_dict(sd, jcfg))
    x = (np.random.default_rng(32).standard_normal((2, 64, 32)) * 0.5).astype(np.float32)

    def loss(p):
        return jnp.mean(jmodel.apply(p, jnp.asarray(x)) ** 2)

    want_logits = jax.jit(jmodel.apply)(params, jnp.asarray(x))
    want_grads = jax.jit(jax.grad(loss))(params)
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), rtol=2e-5, atol=2e-5)
    (model(torch.from_numpy(x)) ** 2).mean().backward()
    grads = {k: np.zeros_like(v) for k, v in sd.items()}
    grads.update({k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None})
    # The port's grads in the JAX layout, by the same porter.
    got_grads = port_aum_state_dict(grads, jcfg)
    checked = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want_grads):
        name = jax.tree_util.keystr(path)
        if "x_proj" not in name and "dt_proj" not in name:
            continue
        g = got_grads
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=3e-4, atol=3e-5,
                                   err_msg=name)
        checked += 1
    assert checked == 3  # x_proj's weight, dt_proj's weight and bias, stacked over layers


@pytest.mark.parametrize("shared", [True, False], ids=["v1", "v2"])
def test_bf16_stage_matches_jax_kernel(shared, monkeypatch):
    """AUM_SCAN_BF16_STAGE=1, bf16 streams: JAX's staged dual forward (eval,
    and the saving form under vjp) against the port's plain version of the
    stage form, outputs within 2e-2 (the JAX package's bound for the form);
    the largest error is printed. fp32 streams never take the form: the
    port's fp32 outputs under the switch equal its default ones exactly."""
    import torch

    from aum_tpu_torch.ops import selective_scan_dual

    _set_switches(monkeypatch, {"AUM_SCAN_BF16_STAGE": "1"})
    a_f = _scan_args(70)
    a_r = _scan_args(71) if not shared else a_f[:2] + [a_f[2] * 0.5] + a_f[3:]
    rng = np.random.default_rng(72)
    w_f, w_r = (rng.standard_normal(a_f[0].shape) for _ in range(2))

    def run(af, ar, cot):
        eval_out = jss.selective_scan_dual(tuple(af), tuple(ar), **KW)
        saving_out, _ = jax.vjp(lambda *a: jss.selective_scan_dual(a[:8], a[8:], **KW),
                                *af, *ar)
        return eval_out, saving_out

    bf = jnp.bfloat16
    jargs = [[jnp.asarray(a, bf if np.ndim(a) == 3 else jnp.float32) for a in args]
             for args in (a_f, a_r)]
    want_eval, want_saving = jax.jit(run)(*jargs, None)

    def port_args(args, dtype):
        return tuple(_torch(a, dtype if np.ndim(a) == 3 else "float32") for a in args)

    tf, tr = port_args(a_f, "bfloat16"), port_args(a_r, "bfloat16")
    with torch.no_grad():
        got_eval = selective_scan_dual(tf, tr)
    leaves = [t.clone().requires_grad_() for t in tf + tr]
    got_saving = selective_scan_dual(tuple(leaves[:8]), tuple(leaves[8:]))
    worst = 0.0
    for got, want in ((got_eval, want_eval), (got_saving, want_saving)):
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(_np(g), w, rtol=2e-2, atol=2e-2)
            worst = max(worst, float(np.abs(_np(g) - w).max()))
    print(f"bf16_stage max |port - jax| = {worst}")
    f32 = port_args(a_f, "float32"), port_args(a_r, "float32")
    with torch.no_grad():
        on = selective_scan_dual(*f32)
        monkeypatch.delenv("AUM_SCAN_BF16_STAGE")
        off = selective_scan_dual(*f32)
        default = selective_scan_dual(tf, tr)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    # The form was taken: its bf16 outputs are not the default's.
    assert not all(torch.equal(a, b) for a, b in zip(got_eval, default))


def _single_scan_grads(monkeypatch, switches, seed):
    """All 8 grads of the single-direction scan (fp32) under ``switches``:
    JAX's kernels in interpret mode, then the port's (plain) path."""
    from aum_tpu_torch.ops import selective_scan

    _set_switches(monkeypatch, switches)
    args = _scan_args(seed)
    w = np.random.default_rng(seed + 1).standard_normal(args[0].shape)

    def grads(a, cot):
        return jax.vjp(lambda *x: jss.selective_scan(*x[:6], z=x[6], delta_bias=x[7],
                                                     delta_softplus=True, use_kernel=True,
                                                     **KW), *a)[1](cot)

    want = jax.jit(grads)([jnp.asarray(a, jnp.float32) for a in args],
                          jnp.asarray(w, jnp.float32))
    leaves = [_torch(a).requires_grad_() for a in args]
    y = selective_scan(*leaves[:7], delta_bias=leaves[7], delta_softplus=True)
    (y * _torch(w)).sum().backward()
    return [t.grad for t in leaves], want


@pytest.mark.parametrize("fused", ["0", "1"], ids=["k2", "fused"])
def test_bwd_bf16_partials_match_jax(fused, monkeypatch):
    """AUM_SCAN_BWD_BF16_PARTIALS=1 on ``_bwd_kernel`` (K2) and
    ``_bwd_kernel_fused``: dB and dC, which go through the bf16 partials
    (JAX rounds per d-tile of 8 channels, the port per block of 32 or 16),
    within 5e-2; every other grad within 2e-5 (the JAX package's bounds for
    this switch)."""
    got, want = _single_scan_grads(
        monkeypatch, {"AUM_SCAN_BWD_BF16_PARTIALS": "1", "AUM_SCAN_BWD_FUSED": fused}, 80)
    for name, g, w in zip(SCAN_NAMES, got, want):
        tol = 5e-2 if name in ("B", "C") else 2e-5
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("knob", ["AUM_SCAN_BWD_XMINUS", "AUM_SCAN_BWD_DBU"])
def test_bwd_dla_modes_match_jax(knob, monkeypatch):
    """``_bwd_kernel``'s dla modes "xminus" and "dbu": all 8 grads within
    2e-5 of JAX's under the same switch (the port's K2 runs one x-minus form
    for both; on the CPU the plain backward, one function)."""
    got, want = _single_scan_grads(monkeypatch, {knob: "1"}, 82)
    for name, g, w in zip(SCAN_NAMES, got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("value", [None, "", "0", "1", "01"], ids=["unset", "empty", "0", "1",
                                                                  "01"])
def test_opt_in_switches_parse_as_jax(value, monkeypatch):
    """AUM_SCAN_FUSE_DT is a string compare ("01" is off), the others read as
    ``_env_int``; XMINUS wins over DBU as in ``_bwd_dla_mode``; bf16 staging
    is off for fp32 streams, the direct kernel and the fuse_dt eval form; the
    bf16 partials and the x-minus form are off for the launch that stands for
    ``_bwd_kernel_dual`` (AUM_SCAN_DUAL_BWD=1, both directions)."""
    import torch

    ss = importlib.import_module("aum_tpu_torch.ops.selective_scan")
    env = {} if value is None else {"AUM_SCAN_FUSE_DT": value}
    _set_switches(monkeypatch, env)
    assert ss.fuse_dt_chosen() is (value == "1")
    on = value not in (None, "", "0")  # "01" is 1 to _env_int
    for name in ("AUM_SCAN_BF16_STAGE", "AUM_SCAN_BWD_BF16_PARTIALS", "AUM_SCAN_BWD_XMINUS",
                 "AUM_SCAN_BWD_DBU"):
        _set_switches(monkeypatch, {} if value is None else {name: value})
        assert ss._env_int(name, 0) == jss._env_int(name, 0)
        assert ss.bwd_dla_mode() == jss._bwd_dla_mode()
    _set_switches(monkeypatch, {} if value is None else {"AUM_SCAN_BF16_STAGE": value})
    assert ss.bf16_stage_chosen(torch.bfloat16, direct=False) is on
    assert not ss.bf16_stage_chosen(torch.float32, direct=False)
    assert not ss.bf16_stage_chosen(torch.bfloat16, direct=True)
    assert not ss.bf16_stage_chosen(torch.bfloat16, direct=False, fuse_dt=True)
    _set_switches(monkeypatch, {"AUM_SCAN_BWD_XMINUS": "1", "AUM_SCAN_BWD_DBU": "1"})
    assert ss.bwd_dla_mode() == jss._bwd_dla_mode() == "xminus"
    _set_switches(monkeypatch, {} if value is None else {"AUM_SCAN_BWD_BF16_PARTIALS": value})
    assert ss.bwd_bf16_partials_chosen(1) is on and ss.bwd_bf16_partials_chosen(2) is on
    monkeypatch.setenv("AUM_SCAN_DUAL_BWD", "1")
    assert ss.bwd_bf16_partials_chosen(1) is on and not ss.bwd_bf16_partials_chosen(2)
