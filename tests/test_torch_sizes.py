"""The port at the sizes the JAX package's ops take beyond the default paths',
against the JAX package, on the CPU.

The port's scan kernels run a d_state above 16 (and a scan without z) as
slices of 16 states and a combine, the conv kernel any width (past 8 its
general form), the fuse_dt form any dt rank (past 400 its windowed form);
on CPU tensors each wrapper runs its plain version (the sequential oracle,
at every N). Here, on inputs drawn with numpy from fixed seeds:
``selective_scan`` forward and every grad at d_state 24 and 40, its
with_state form chained at 24, and without D and/or z (JAX's oracle path);
``selective_scan_dual`` (v1) at 32; the conv forward and backward at widths
2, 3, 6, 12 and 40 (wider than its L of 35), causal and anti-causal; the
fuse_dt form at dt ranks 80 and 420 (JAX pads them to 128 and 512); the
combine's plain version over per-slice oracle outputs against the unsliced
oracle, and its backward's over per-slice oracle grads at an L that is not
a multiple of the kernel's chunk; the sequence-parallel scan and the decode
state update at d_state 24; a depth-2 Mamba LM with d_state 32 and d_conv 3
or 12 (logits and caches) and a depth-2 tiny AuM at d_state 40 (logits and
a train step's loss and grads). The JAX side runs its Pallas kernels in interpret mode,
jitted, as its own tests do (d_block 8, l_chunk 8). fp32 throughout;
tolerances as ``tests/test_torch_scan_opt_in.py`` states them: forward
2e-5, grads 3e-4 of the reference's max-abs.
"""

import functools
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.ops.conv1d import causal_conv1d as jax_conv
from aum_tpu.ops.scan_ref import selective_scan_ref as jax_scan_ref
from aum_tpu.ops.state_update import selective_state_update as jax_state_update

jss = importlib.import_module("aum_tpu.ops.selective_scan")  # the module, not the op

KW = dict(d_block=8, l_chunk=8, interpret=True)
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 3e-4  # of the reference's max-abs
SCAN_NAMES = ("u", "delta", "A", "B", "C", "D", "z", "bias")


def _torch(a):
    import torch

    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return t.detach().float().numpy()


def _close_scaled(got, want, tol=GRAD_TOL, name=""):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (name, err, np.abs(want).max())


def _scan_args(seed, n, bsz=2, seqlen=37, d=24):
    """(u, delta, A, B, C, D, z, delta_bias) as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((bsz, seqlen, d)), rng.standard_normal((bsz, seqlen, d)) * 0.5,
           -np.exp(rng.standard_normal((d, n)) * 0.5), rng.standard_normal((bsz, seqlen, n)),
           rng.standard_normal((bsz, seqlen, n)), rng.standard_normal(d),
           rng.standard_normal((bsz, seqlen, d)), rng.standard_normal(d) * 0.3]
    return [a.astype(np.float32) for a in out]


def _jax_scan_vjp(args, w, with_d=True, with_z=True):
    """JAX's selective_scan (its Pallas kernel with D and z, else its oracle)
    and the grads of sum(y w)."""
    def loss(ls):
        u, delta, A, B, C, D, z, bias = ls[:8]
        out = jss.selective_scan(u, delta, A, B, C, D if with_d else None, z if with_z else None,
                                 bias, delta_softplus=True, **KW)
        return jnp.sum(out * w[0]), out

    leaves = [jnp.asarray(a) for a in args]
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(leaves)
    return out, grads


@pytest.mark.parametrize("n", [24, 40])
def test_scan_matches_jax_kernel_at_wide_states(n):
    """d_state above 16 (one and a half and two and a half slices): the
    output and all 8 grads against JAX's kernel, which pads N to a multiple
    of 8 and sums over it."""
    from aum_tpu_torch.ops import selective_scan

    args = _scan_args(70 + n, n)
    w = np.random.default_rng(71).standard_normal(args[0].shape).astype(np.float32)
    want, grads = _jax_scan_vjp(args, [w])
    leaves = [_torch(a).requires_grad_() for a in args]
    y = selective_scan(*leaves[:7], delta_bias=leaves[7], delta_softplus=True)
    np.testing.assert_allclose(_np(y), np.asarray(want), **FWD_TOL)
    (y * _torch(w)).sum().backward()
    for name, t, g in zip(SCAN_NAMES, leaves, grads):
        _close_scaled(_np(t.grad), g, name=name)


def test_scan_with_state_chains_at_wide_state():
    """d_state 24 with a carried state: the with_state form (a random x0 in,
    the final state out) against JAX's, output, final state and every grad
    (x0's too); and two chained segments from the same x0 (the second started
    from the first's final state) against JAX's unsplit output."""
    from aum_tpu_torch.ops import selective_scan

    n = 24
    args = _scan_args(72, n)
    rng = np.random.default_rng(73)
    x0 = rng.standard_normal((2, 24, n)).astype(np.float32)
    w = [rng.standard_normal(args[0].shape).astype(np.float32),
         rng.standard_normal((2, 24, n)).astype(np.float32)]
    (want_y, want_fin), grads = _jax_scan_state(args, x0, w)
    leaves = [_torch(a).requires_grad_() for a in args + [x0]]
    y, fin = selective_scan(*leaves[:7], delta_bias=leaves[7], delta_softplus=True,
                            initial_state=leaves[8], return_final_state=True)
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **FWD_TOL)
    np.testing.assert_allclose(_np(fin), np.asarray(want_fin), **FWD_TOL)
    ((y * _torch(w[0])).sum() + (fin * _torch(w[1])).sum()).backward()
    for name, t, g in zip(SCAN_NAMES + ("x0",), leaves, grads):
        _close_scaled(_np(t.grad), g, name=name)
    # Chained at an uneven split, against the unsplit scan.
    import torch

    u, delta, A, B, C, D, z, bias = (_torch(a) for a in args)
    with torch.no_grad():
        y_a, state = selective_scan(u[:, :15], delta[:, :15], A, B[:, :15], C[:, :15], D,
                                    z[:, :15], bias, True, initial_state=_torch(x0),
                                    return_final_state=True)
        y_b, fin_b = selective_scan(u[:, 15:], delta[:, 15:], A, B[:, 15:], C[:, 15:], D,
                                    z[:, 15:], bias, True, initial_state=state,
                                    return_final_state=True)
    np.testing.assert_allclose(_np(torch.cat((y_a, y_b), dim=1)), np.asarray(want_y),
                               **FWD_TOL)
    np.testing.assert_allclose(_np(fin_b), np.asarray(want_fin), **FWD_TOL)


def _jax_scan_state(args, x0, w):
    def loss(ls):
        y, fin = jss.selective_scan(*ls[:7], ls[7], delta_softplus=True, initial_state=ls[8],
                                    return_final_state=True, **KW)
        return jnp.sum(y * w[0]) + jnp.sum(fin * w[1]), (y, fin)

    leaves = [jnp.asarray(a) for a in args + [x0]]
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(leaves)
    return out, grads


@pytest.mark.parametrize("with_d, with_z", [(False, False), (True, False), (False, True)],
                         ids=["bare", "no_z", "no_D"])
def test_scan_without_d_or_z_matches_jax(with_d, with_z):
    """The scan without D and/or z (the port: the ungated kernels' plain
    version and the combine's; JAX: its oracle path), output and grads."""
    from aum_tpu_torch.ops import selective_scan

    args = _scan_args(74, 8)
    w = np.random.default_rng(75).standard_normal(args[0].shape).astype(np.float32)
    want, grads = _jax_scan_vjp(args, [w], with_d, with_z)
    leaves = [_torch(a).requires_grad_() for a in args]
    y = selective_scan(*leaves[:5], leaves[5] if with_d else None,
                       leaves[6] if with_z else None, delta_bias=leaves[7], delta_softplus=True)
    np.testing.assert_allclose(_np(y), np.asarray(want), **FWD_TOL)
    (y * _torch(w)).sum().backward()
    for name, t, g in zip(SCAN_NAMES, leaves, grads):
        if (name == "D" and not with_d) or (name == "z" and not with_z):
            assert t.grad is None
            continue
        _close_scaled(_np(t.grad), g, name=name)


def test_dual_scan_matches_jax_kernel_at_wide_state():
    """``selective_scan_dual`` v1 (shared operands, A_b its own) at d_state
    32: both outputs and the grads of the 8 shared leaves and A_b against
    JAX's dual kernel and its backward."""
    from aum_tpu_torch.ops import selective_scan_dual

    args = _scan_args(76, 32)
    a_b = (args[2] * 0.7).astype(np.float32)
    rng = np.random.default_rng(77)
    w = [rng.standard_normal(args[0].shape).astype(np.float32) for _ in range(2)]

    def loss(ls):
        y_f, y_r = jss.selective_scan_dual(tuple(ls[:8]), tuple(ls[:2]) + (ls[8],)
                                           + tuple(ls[3:8]), d_block=8, l_chunk=8,
                                           interpret=True)
        return jnp.sum(y_f * w[0]) + jnp.sum(y_r * w[1]), (y_f, y_r)

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        [jnp.asarray(a) for a in args + [a_b]])
    leaves = [_torch(a).requires_grad_() for a in args + [a_b]]
    y_f, y_r = selective_scan_dual(tuple(leaves[:8]),
                                   tuple(leaves[:2]) + (leaves[8],) + tuple(leaves[3:8]))
    for got, ref in zip((y_f, y_r), want):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **FWD_TOL)
    ((y_f * _torch(w[0])).sum() + (y_r * _torch(w[1])).sum()).backward()
    for name, t, g in zip(SCAN_NAMES + ("A_b",), leaves, grads):
        _close_scaled(_np(t.grad), g, name=name)


@pytest.mark.parametrize("k", [2, 3, 6, 12, 40])
@pytest.mark.parametrize("reverse", [False, True], ids=["causal", "anti_causal"])
def test_conv_matches_jax_kernel_at_widths(k, reverse):
    """The conv (bias, SiLU) at widths other than 4, 12 and 40 among them
    (the kernel's general form; 40 is wider than L): output and the grads of
    x, the taps and the bias against JAX's ``_conv_kernel`` and its VJP."""
    from aum_tpu_torch.ops import causal_conv1d

    rng = np.random.default_rng(80 + k)
    x = rng.standard_normal((2, 35, 24)).astype(np.float32)
    w = (rng.standard_normal((24, k)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(24) * 0.2).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def loss(x, w, b):
        out = jax_conv(x, w, b, activation="silu", reverse=reverse, use_kernel=True,
                       interpret=True)
        return jnp.sum(out * cot), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    leaves = [_torch(a).requires_grad_() for a in (x, w, b)]
    out = causal_conv1d(*leaves, activation="silu", reverse=reverse)
    np.testing.assert_allclose(_np(out), np.asarray(want), **FWD_TOL)
    (out * _torch(cot)).sum().backward()
    for name, t, g in zip(("x", "weight", "bias"), leaves, grads):
        _close_scaled(_np(t.grad), g, name=name)


@pytest.mark.parametrize("rank", [80, 420])
def test_fuse_dt_matches_jax_kernel_at_ranks(rank, monkeypatch):
    """AUM_SCAN_FUSE_DT=1 at dt rank 80 (past the 64 the kernel once took)
    and 420 (past the 400 its operands fit a block whole: the kernel's
    windowed form; JAX pads them to 128 and 512): the fuse_dt dual forward's
    plain version against JAX's kernel, v1, within 2e-5."""
    import torch

    from aum_tpu_torch.ops import selective_scan_dual

    monkeypatch.setenv("AUM_SCAN_FUSE_DT", "1")
    rng = np.random.default_rng(84)
    u, _, A, B, C, D, z, bias = _scan_args(85, 8)
    dtr = (rng.standard_normal((2, 37, rank)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((rank, 24)) * 0.15 * np.sqrt(80 / rank)).astype(np.float32)
    a_b = (A * 0.7).astype(np.float32)

    def run(t, **kw):
        fwd = (t(u), None, t(A), t(B), t(C), t(D), t(z), t(bias))
        rev = fwd[:2] + (t(a_b),) + fwd[3:]
        return fwd, rev, ((t(dtr), t(w)), (t(dtr), t(w)))

    fwd, rev, fold = run(jnp.asarray)
    want = jax.jit(lambda: jss.selective_scan_dual(fwd, rev, dt_fold=fold, d_block=8,
                                                   l_chunk=8, interpret=True))()
    fwd, rev, fold = run(_torch)
    with torch.no_grad():
        got = selective_scan_dual(fwd, rev, dt_fold=fold)
    for g, ref in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("gated,backward", [(True, False), (False, False), (True, True)],
                         ids=["D_z", "no_D_z", "backward"])
def test_combine_of_slices_matches_the_oracle(gated, backward):
    """The kernels' decomposition at d_state 40: the oracle ungated and
    without D on each of ``state_slices`` (16, 16, 8 states), its fp32
    outputs summed by the combine's plain version ``scan_combine_plain``
    (with D and z, or without them), its chunk and final states side by
    side, against the unsliced oracle from a carried state. The backward
    case: at L = 45 (not a multiple of ``COMBINE_BWD_CHUNK``), each slice's
    fp32 du and ddelta grads from the gated cotangent g silu(z) and its y,
    combined by ``scan_combine_bwd_plain``, against the unsliced oracle's
    grads of u, delta, z, D and the bias."""
    import torch

    ss = importlib.import_module("aum_tpu_torch.ops.selective_scan")
    from aum_tpu_torch.ops.scan_ref import selective_scan_ref

    n = 40
    if backward:
        _check_combine_bwd(ss, selective_scan_ref, n, seqlen=45)
        return
    u, delta, A, B, C, D, z, bias = (_torch(a) for a in _scan_args(86, n, seqlen=70))
    assert ss.sliced_form(n, z) and ss.sliced_form(16, None) and not ss.sliced_form(16, z)
    D, z = (D, z) if gated else (None, None)
    dt = ss._prep_dt(delta, bias)
    x0 = _torch(np.random.default_rng(87).standard_normal((2, 24, n)))
    assert ss.state_slices(n) == [(0, 16), (16, 32), (32, 40)]
    for reverse in (False, True):
        parts = [selective_scan_ref(u, dt, A[:, n0:n1], B[..., n0:n1], C[..., n0:n1],
                                    reverse=reverse, save_every=ss.STATE_CHUNK,
                                    initial_state=x0[..., n0:n1], return_last_state=True)
                 for n0, n1 in ss.state_slices(n)]
        got = (ss.scan_combine_plain(torch.stack([p[0] for p in parts]), u, D, z),
               torch.cat([p[1] for p in parts], dim=2), torch.cat([p[2] for p in parts], dim=2))
        want = selective_scan_ref(u, dt, A, B, C, D, z, reverse=reverse,
                                  save_every=ss.STATE_CHUNK, initial_state=x0,
                                  return_last_state=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), **FWD_TOL)


def _check_combine_bwd(ss, scan_ref, n, seqlen):
    import torch

    assert seqlen % ss.COMBINE_BWD_CHUNK != 0
    u, delta, A, B, C, D, z, bias = (_torch(a).requires_grad_()
                                     for a in _scan_args(91, n, seqlen=seqlen))
    g = _torch(np.random.default_rng(92).standard_normal(u.shape))
    for reverse in (False, True):
        leaves = (u, delta, z, D, bias)
        out = scan_ref(u, ss._prep_dt(delta, bias), A, B, C, D, z, reverse=reverse)
        want = torch.autograd.grad((out * g).sum(), leaves)
        gy = (g * torch.nn.functional.silu(z)).detach()
        du_parts, dd_parts, y_parts = [], [], []
        for n0, n1 in ss.state_slices(n):
            y_s = scan_ref(u, ss._prep_dt(delta, bias), A[:, n0:n1], B[..., n0:n1],
                           C[..., n0:n1], reverse=reverse)
            du_s, dd_s = torch.autograd.grad((y_s * gy).sum(), (u, delta))
            du_parts.append(du_s)
            dd_parts.append(dd_s)
            y_parts.append(y_s.detach())
        got = ss.scan_combine_bwd_plain(torch.stack(du_parts), torch.stack(dd_parts),
                                        torch.stack(y_parts), g, z.detach(), u.detach(),
                                        D.detach())
        for name, gt, w in zip(("du", "ddelta", "dz", "dD", "dbias"), got, want):
            _close_scaled(_np(gt), _np(w), name=name)


@pytest.fixture(scope="module", autouse=True)
def seq_parallel_run():
    """The sequence-parallel scan's two gloo ranks, started before the
    module's first test so that their start-up overlaps the JAX compiles:
    (the cases, a function returning rank 0's results)."""
    from aum_tpu_torch.parallel.launch import start

    rng = np.random.default_rng(88)
    cases = []
    for reverse in (False, True):
        args = _scan_args(89 + reverse, 24, seqlen=20, d=8)
        cases.append({"args": args, "reverse": reverse,
                      "x0": rng.standard_normal((2, 8, 24)).astype(np.float32),
                      "w": rng.standard_normal((2, 20, 8)).astype(np.float32),
                      "wf": rng.standard_normal((2, 8, 24)).astype(np.float32)})
    ranks = start("aum_tpu_torch.parallel.checks:scan_leg", 2,
                  {"cases": cases, "n_seq": 2, "device": "cpu"}, backend="gloo", device="cpu")
    joined = functools.cache(lambda: ranks.join()[0])
    yield cases, joined
    joined()


def test_seq_parallel_scan_matches_jax_at_wide_state(seq_parallel_run):
    """The sequence-parallel scan (two gloo ranks on the CPU, each scanning
    its half with a carried state) at d_state 24, forward and reverse from a
    random x0: y, the final state and every grad against JAX's oracle."""
    cases, joined = seq_parallel_run
    for case, res in zip(cases, joined()):
        def loss(args, x0):
            y, fin = jax_scan_ref(*args, delta_softplus=True, reverse=case["reverse"],
                                  return_last_state=True, initial_state=x0)
            return jnp.sum(y * case["w"]) + jnp.sum(fin * case["wf"]), (y, fin)

        (_, (y, fin)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            [jnp.asarray(a) for a in case["args"]], jnp.asarray(case["x0"]))
        np.testing.assert_allclose(res["y"], np.asarray(y), **FWD_TOL)
        np.testing.assert_allclose(res["final"], np.asarray(fin), **FWD_TOL)
        for i, (g, w) in enumerate(zip(res["grads"], list(grads[0]) + [grads[1]])):
            _close_scaled(g, w, tol=1e-4, name=i)


def test_state_update_matches_jax_at_wide_state():
    """One decode step of the SSM (plain PyTorch in both packages) at
    d_state 24, with D, z and the softplus."""
    from aum_tpu_torch.ops import selective_state_update

    rng = np.random.default_rng(90)
    b, d, n = 3, 16, 24
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    state, x, dt, bm, cm = f(b, d, n), f(b, d), f(b, d), f(b, n), f(b, n)
    a, dskip, z, dt_bias = -np.exp(f(d, n)), f(d), f(b, d), f(d)
    want = jax_state_update(*map(jnp.asarray, (state, x, dt, a, bm, cm)), D=jnp.asarray(dskip),
                            z=jnp.asarray(z), dt_bias=jnp.asarray(dt_bias), dt_softplus=True)
    got = selective_state_update(*map(_torch, (state, x, dt, a, bm, cm)), D=_torch(dskip),
                                 z=_torch(z), dt_bias=_torch(dt_bias), dt_softplus=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d_conv", [3, 12], ids=["conv_3", "conv_12"])
def test_lm_with_wide_state_and_conv_matches_jax(d_conv):
    """A depth-2 Mamba LM with d_state 32 and d_conv 3 or 12 (the conv
    kernel's general form; wider than the 7-token prompt), the port's
    weights carried into the JAX model by its porter: prefill's last logits
    and both caches."""
    import torch

    from aum_tpu.models import lm as jlm
    from aum_tpu_torch.models.lm import MambaLM, MambaLMConfig, prefill

    cfg = jlm.MambaLMConfig(d_model=32, n_layer=2, vocab_size=60, d_state=32, d_conv=d_conv)
    ids = np.array([[5, 17, 3, 42, 8, 13, 21], [2, 9, 31, 7, 1, 44, 0]], np.int32)
    port_cfg = MambaLMConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    model = MambaLM(port_cfg, device="cpu", seed=1)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = jax.tree.map(jnp.asarray, jlm.port_lm_state_dict(sd, cfg))
    want_logits, want_state = jax.jit(lambda i: jlm.prefill(params, cfg, i))(jnp.asarray(ids))
    logits, state = prefill(model, torch.from_numpy(ids).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **FWD_TOL)
    assert state["conv"].shape == (2, 2, 64, d_conv) and state["ssm"].shape == (2, 2, 64, 32)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(want_state[k]), **FWD_TOL)


def test_tiny_aum_with_wide_state_matches_jax():
    """A depth-2 tiny Fo-Bi AuM (embed 64, 9 tokens) at d_state 40, the port's
    weights carried into the JAX model by its porter: the logits (JAX: its
    dual kernel; the port: the sliced plain form), then one train step's
    loss (BCE) and the grads of every parameter."""
    import torch

    from aum_tpu.convert.torch_port import port_aum_state_dict
    from aum_tpu.models import AudioMamba as JaxAudioMamba
    from aum_tpu.models import AudioMambaConfig as JaxConfig
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    kw = dict(spectrogram_size=(32, 64), depth=2, embed_dim=64, d_state=40, num_classes=5,
              bimamba_type="v1", remat=False)
    model = AudioMamba(AudioMambaConfig(**kw), device="cpu", seed=33)
    jcfg = JaxConfig(**kw)
    jmodel = JaxAudioMamba(jcfg, use_kernel=True)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = jax.tree.map(jnp.asarray, port_aum_state_dict(sd, jcfg))
    rng = np.random.default_rng(34)
    x = (rng.standard_normal((2, 64, 32)) * 0.5).astype(np.float32)
    y = (rng.random((2, 5)) < 0.5).astype(np.float32)

    def loss(p):
        logits = jmodel.apply(p, jnp.asarray(x))
        bce = jnp.maximum(logits, 0) - logits * y + jnp.log1p(jnp.exp(-jnp.abs(logits)))
        return jnp.mean(bce), logits

    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), **FWD_TOL)
    got_loss = torch.nn.functional.binary_cross_entropy_with_logits(logits, torch.from_numpy(y))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    got_loss.backward()
    grads = {k: np.zeros_like(v) for k, v in sd.items()}
    grads.update({k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None})
    got_grads = port_aum_state_dict(grads, jcfg)
    checked = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want_grads):
        g = got_grads
        for key in path:
            g = g[key.key]
        _close_scaled(np.asarray(g), w, name=jax.tree_util.keystr(path))
        checked += 1
    assert checked > 10
