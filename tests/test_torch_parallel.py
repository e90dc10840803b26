"""The port's parallel modes (``aum_tpu_torch.parallel``) against the JAX package, on the CPU.

The port runs one process per rank over gloo (``parallel/launch.py``); the
rank bodies live in ``aum_tpu_torch/parallel/checks.py``. One spawn of four
ranks runs every layout's leg, while the JAX references compile in this
process (unsharded, ``use_kernel=False``: the JAX tests show the sharded
runs equal to it; the pipeline with drop path on the JAX package's
8-device CPU mesh, whose drawn scales are replayed into the port):

- the sequence-parallel scan, forward and reverse, with and without an
  initial state, at S = 2 and 4: outputs within 2e-5 and every grad within
  1e-4 of its largest element, against the JAX oracle and ``jax.grad``;
- the tensor-parallel model (data 2 x model 2), v1 and v2: logits within
  1e-5 and every grad within 1e-4 of its largest element;
- one train step each of data 2 x model 2, data 2 x seq 2 and data 2 x
  pipe 2 (depth 4, 2 microbatches), and the pipe one with drop path on
  JAX's drawn scales: the loss within 1e-5 and the updated parameters
  within 2e-5 of ``aum_tpu.train.loop.make_train_step`` on the global batch;
- a checkpoint of a one-process run restored into a pipe 2 x model 2 run,
  stepped, saved, and restored into one process;
- a data-parallel and a tensor-parallel bundle's ``predict`` on two ranks
  against the one-process bundle's;
- the leaf table (every d_inner leaf sharded), the data order per rank
  against JAX's process slicing, ``dryrun_multichip(4)``, and that no
  module of the port (nor ``chip_smoke.py``) imports JAX or ``aum_tpu``.

Inputs are drawn with numpy from fixed seeds; torch is imported inside the
tests, as in the other port test modules.
"""

import ast
import functools
import pathlib
import types

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from aum_tpu.convert.torch_port import port_aum_state_dict
from aum_tpu.ops.scan_ref import selective_scan_ref as jscan_ref
from scripts.record_goldens import build_flax

ROOT = pathlib.Path(__file__).resolve().parents[1]
# remat off in JAX (a smaller compile); the port's split remat gives the
# same numbers and exercises the recompute of the TP all-reduce.
JAX_KW = dict(spectrogram_size=(32, 64), depth=2, embed_dim=64, d_state=16, num_classes=5,
              remat=False)
PORT_EXTRA = dict(remat=True, remat_mode="split")
PIPE_DEPTH = 4
DROP_RATE = 0.5
SEED = 21
HP = dict(lr=1e-3, weight_decay=1e-2, warmup=False)
BATCH = 4
SCAN_SHAPES = dict(bsz=2, length=16, d=8, n=4)


def _jax_kw(bimamba, depth=2, **kw):
    return {**JAX_KW, "bimamba_type": bimamba, "depth": depth, **kw}


def _port_kw(bimamba, depth=2, **kw):
    return {**_jax_kw(bimamba, depth, **kw), **PORT_EXTRA}


def _batch():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((BATCH, 64, 32)) * 0.5).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[np.arange(BATCH) % 5]
    return x, y


def _port_sd(kw):
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    model = AudioMamba(AudioMambaConfig(**kw), device="cpu", seed=SEED)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _recording(tx):
    """tx, keeping the raw grads of its update in its state."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def _jax_step(jkw, mesh=None, model_kw=None, logits=False):
    """One ``make_train_step`` step of JAX's model from the port's weights on
    ``_batch()`` (rng PRNGKey(0)): (loss, grads, params after, eval logits
    where asked, config), as numpy trees."""
    from aum_tpu.models import AudioMamba
    from aum_tpu.parallel import shard_params
    from aum_tpu.train.loop import AugmentConfig, TrainState, make_train_step
    from aum_tpu.train.optim import TrainHyperParams, make_optimizer

    jcfg, jmodel = build_flax(jkw)
    params = jax.tree.map(jnp.asarray,
                          port_aum_state_dict(_port_sd({**jkw, "drop_path_rate": 0.0}), jcfg))
    if logits:
        logits = np.asarray(jmodel.apply(params, jnp.asarray(_batch()[0])))
    if model_kw:
        jmodel = AudioMamba(jcfg, use_kernel=False, **model_kw)
    tx = _recording(make_optimizer(TrainHyperParams(**HP), steps_per_epoch=100))
    x, y = _batch()

    def run():
        p = shard_params(params, mesh) if mesh is not None else params
        state = TrainState(step=jnp.zeros((), jnp.int32), params=p, opt_state=tx.init(p),
                           loss_sum=jnp.zeros((), jnp.float32),
                           nonfinite_count=jnp.zeros((), jnp.int32))
        step = make_train_step(jmodel, tx, mesh, "BCE", AugmentConfig(), donate=False)
        return step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jax.random.PRNGKey(0))

    if mesh is not None:
        with jax.set_mesh(mesh):
            state, loss = run()
    else:
        state, loss = run()
    return (float(loss), jax.device_get(state.opt_state[0]), jax.device_get(state.params),
            logits, jcfg)


def _jax_drop_masks(depth, rate, batch):
    """The drop-path masks JAX's pipelined model draws in the step above
    (``audio_mamba.py``'s pipelined branch, then the final ``_drop_path``):
    the model's first two ``make_rng("dropout")`` keys under the step's
    ``fold_in(rng, 0x0D09)``, replayed from a module at the same (root)
    scope. The pipe step's loss against JAX's checks the replay."""

    class _Keys(nn.Module):
        @nn.compact
        def __call__(self):
            return self.make_rng("dropout"), self.make_rng("dropout")

    k_layers, k_final = _Keys().apply(
        {}, rngs={"dropout": jax.random.fold_in(jax.random.PRNGKey(0), 0x0D09)})
    dpr = np.linspace(0.0, rate, depth)
    keep = 1.0 - jnp.asarray(np.concatenate([[0.0], dpr[:-1]]).astype(np.float32))
    layers = jax.vmap(lambda k, p: jax.random.bernoulli(k, p, (batch,)))(
        jax.random.split(k_layers, depth), keep)
    final = jax.random.bernoulli(k_final, jnp.float32(1.0) - jnp.float32(rate), (batch, 1, 1))
    return np.asarray(layers), np.asarray(final).reshape(batch)


def _scan_cases():
    rng = np.random.default_rng(7)
    b, length, d, n = (SCAN_SHAPES[k] for k in ("bsz", "length", "d", "n"))
    cases = []
    for reverse in (False, True):
        for with_x0 in (False, True):
            args = [rng.standard_normal((b, length, d)), rng.standard_normal((b, length, d)) * 0.5,
                    -np.exp(rng.standard_normal((d, n)) * 0.3), rng.standard_normal((b, length, n)),
                    rng.standard_normal((b, length, n)), rng.standard_normal(d),
                    rng.standard_normal((b, length, d)), rng.standard_normal(d) * 0.2]
            cases.append({"args": [a.astype(np.float32) for a in args], "reverse": reverse,
                          "x0": (rng.standard_normal((b, d, n)).astype(np.float32)
                                 if with_x0 else None),
                          "w": rng.standard_normal((b, length, d)).astype(np.float32),
                          "wf": rng.standard_normal((b, d, n)).astype(np.float32)})
    return cases


@functools.lru_cache(maxsize=None)
def _jax_scan_grads(reverse, with_x0):
    def loss(args, x0, w, wf):
        y, fin = jscan_ref(*args, delta_softplus=True, reverse=reverse, return_last_state=True,
                           initial_state=x0)
        return jnp.sum(y * w) + jnp.sum(fin * wf), (y, fin)

    return jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))


def _ckpt_one_process(directory):
    """A one-process run of the pipe config after one step, saved as
    ``epoch_1``: (its params by name)."""
    import torch

    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.train import (
        Checkpointer,
        TrainHyperParams,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    hp = TrainHyperParams(**HP)
    model = AudioMamba(AudioMambaConfig(**_port_kw("v1", PIPE_DEPTH)), device="cpu", seed=SEED)
    state = init_train_state(model, make_optimizer(model.parameters(), hp))
    x, y = _batch()
    state, _ = make_train_step(hp, 100, "BCE")(state, {"x": torch.from_numpy(x),
                                                       "y": torch.from_numpy(y)})
    Checkpointer(directory).save_latest(state, 1, {})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four-rank suite's results (started first) and the JAX references
    (computed while the ranks run)."""
    from aum_tpu_torch.parallel.launch import start

    tmp = tmp_path_factory.mktemp("parallel")
    x, y = _batch()
    masks = _jax_drop_masks(PIPE_DEPTH, DROP_RATE, BATCH)
    _ckpt_one_process(str(tmp / "one"))
    train = dict(seed=SEED, x=x, y=y, hp=HP)
    pipe = {"n_data": 2, "n_pipe": 2, "pipe_microbatches": 2}
    legs = [
        ("dp_tp_v1", "train_leg", dict(layout={"n_data": 2, "n_model": 2},
                                       config=_port_kw("v1"), **train)),
        ("dp_tp_v2", "train_leg", dict(layout={"n_data": 2, "n_model": 2},
                                       config=_port_kw("v2"), **train)),
        ("dp_sp_v1", "train_leg", dict(layout={"n_data": 2, "n_seq": 2},
                                       config=_port_kw("v1"), **train)),
        ("dp_pp", "train_leg", dict(layout=pipe, config=_port_kw("v1", PIPE_DEPTH), grads=False,
                                    **train)),
        ("dp_pp_drop", "train_leg", dict(layout=pipe, drop_masks=masks, grads=False,
                                         config=_port_kw("v1", PIPE_DEPTH,
                                                         drop_path_rate=DROP_RATE), **train)),
        ("scan_s2", "scan_leg", dict(cases=_scan_cases(), n_seq=2)),
        ("scan_s4", "scan_leg", dict(cases=_scan_cases(), n_seq=4)),
        ("ckpt", "checkpoint_leg", dict(layout={"n_pipe": 2, "n_model": 2},
                                        config=_port_kw("v1", PIPE_DEPTH), seed=SEED, x=x, y=y,
                                        hp=HP, restore_dir=str(tmp / "one"),
                                        save_dir=str(tmp / "par"))),
    ]
    legs = [(name, fn, {**kw, "device": "cpu"}) for name, fn, kw in legs]
    ranks = start("aum_tpu_torch.parallel.checks:suite_leg", 4, {"legs": legs},
                  backend="gloo", device="cpu")
    ref = {"v1": _jax_step(_jax_kw("v1"), logits=True), "v2": _jax_step(_jax_kw("v2"), logits=True),
           "pp": _jax_step(_jax_kw("v1", PIPE_DEPTH))}
    from aum_tpu.parallel import make_mesh as jax_make_mesh

    ref["pp_drop"] = _jax_step(
        _jax_kw("v1", PIPE_DEPTH, drop_path_rate=DROP_RATE),
        mesh=jax_make_mesh(n_data=2, n_pipe=2, devices=jax.devices()[:4]),
        model_kw=dict(pipe_axis="pipe", pipe_microbatches=2))
    scans = {}
    for i, case in enumerate(_scan_cases()):
        grads, (yv, fin) = _jax_scan_grads(case["reverse"], case["x0"] is not None)(
            [jnp.asarray(a) for a in case["args"]],
            None if case["x0"] is None else jnp.asarray(case["x0"]), case["w"], case["wf"])
        scans[i] = (np.asarray(yv), np.asarray(fin),
                    [np.asarray(g) for g in grads[0]]
                    + ([np.asarray(grads[1])] if case["x0"] is not None else []))
    ref["scan"] = scans
    return {"port": ranks.join()[0], "jax": ref, "tmp": tmp, "masks": masks}


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _sd(tree, jcfg):
    from aum_tpu_torch.convert import state_dict_from_jax

    return {k: v.numpy() for k, v in state_dict_from_jax(tree, jcfg).items()}


@pytest.mark.parametrize("n_seq", [2, 4])
@pytest.mark.parametrize("case", range(4), ids=["fwd", "fwd_x0", "rev", "rev_x0"])
def test_seq_parallel_scan_matches_jax(runs, n_seq, case):
    got = runs["port"][f"scan_s{n_seq}"][case]
    y, fin, grads = runs["jax"]["scan"][case]
    np.testing.assert_allclose(got["y"], y, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got["final"], fin, atol=2e-5, rtol=2e-5)
    assert len(got["grads"]) == len(grads)
    for i, (g, w) in enumerate(zip(got["grads"], grads)):
        # fp32; the exchange and the two passes sum in other orders.
        assert _max_rel(g, w) <= 1e-4, i


@pytest.mark.parametrize("bimamba", ["v1", "v2"])
def test_tensor_parallel_logits_and_grads_match_jax(runs, bimamba):
    got = runs["port"][f"dp_tp_{bimamba}"]
    want_loss, grads, _, logits, jcfg = runs["jax"][bimamba]
    np.testing.assert_allclose(got["logits"], logits, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    want = _sd(grads, jcfg)
    assert set(got["grads"]) == set(want)
    for k, w in want.items():
        assert _max_rel(got["grads"][k], w) <= 1e-4, k


@pytest.mark.parametrize("leg,ref", [("dp_tp_v1", "v1"), ("dp_tp_v2", "v2"), ("dp_sp_v1", "v1"),
                                     ("dp_pp", "pp"), ("dp_pp_drop", "pp_drop")])
def test_parallel_train_step_matches_jax(runs, leg, ref):
    got = runs["port"][leg]
    want_loss, _, params, _, jcfg = runs["jax"][ref]
    np.testing.assert_allclose(got["losses"][0], want_loss, rtol=1e-5)
    want = _sd(params, jcfg)
    assert set(got["params"]) == set(want)
    for k, w in want.items():
        # Adam moves each parameter by about lr whatever its grad: the fp32
        # noise of a grad near zero shows at 2% of one lr (as in
        # tests/test_torch_train.py).
        np.testing.assert_allclose(got["params"][k], w, rtol=1e-5, atol=2e-5, err_msg=k)


def test_pipe_drop_path_replays_masks_that_drop(runs):
    """The replayed masks drop samples (the drop-path step is not a no-op)."""
    layers, final = runs["masks"]
    assert not layers.all() and not final.all()


def test_sequence_parallel_runs_no_dual_kernel_and_moves_its_bytes(runs):
    counts = runs["port"]["dp_sp_v1"]["grad_counts"]
    assert counts["launches"]["selective_scan_dual_fwd"] == 0
    # Per direction and layer: two segment scans with carried state, both
    # differentiated through the with_state backward (plain versions here).
    assert counts["bytes"]["sp_output"] > 0 and counts["bytes"]["sp_summary_bwd"] > 0
    assert "tp_x_dbl" not in counts["bytes"]
    tp = runs["port"]["dp_tp_v1"]["grad_counts"]["bytes"]
    # x_dbl is summed forward, again in split remat's recompute, and backward.
    assert tp["tp_x_dbl"] == 2 * tp["tp_x_dbl_bwd"] and tp["tp_out"] == tp["tp_input_bwd"]


def test_checkpoint_round_trip_between_parallel_and_one_process(runs):
    import torch

    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.train import (
        Checkpointer,
        TrainHyperParams,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    got = runs["port"]["ckpt"]
    one = Checkpointer(str(runs["tmp"] / "one"))
    for k, v in one.model_state("epoch_1").items():
        np.testing.assert_array_equal(got["restored"][k], v.numpy(), err_msg=k)
    # The parallel run's checkpoint into one process: its gathered state.
    hp = TrainHyperParams(**HP)
    model = AudioMamba(AudioMambaConfig(**_port_kw("v1", PIPE_DEPTH)), device="cpu", seed=0)
    state = init_train_state(model, make_optimizer(model.parameters(), hp))
    state = Checkpointer(str(runs["tmp"] / "par")).restore("epoch_2", state)
    assert state.step == got["step"] == 2
    for k, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), got["after"][k], err_msg=k)
        np.testing.assert_array_equal(state.optimizer.state[p]["exp_avg"].numpy(),
                                      got["exp_avg"][k], err_msg=k)
    # ... and equal to one process's own second step from the same checkpoint.
    ref = AudioMamba(AudioMambaConfig(**_port_kw("v1", PIPE_DEPTH)), device="cpu", seed=0)
    rstate = one.restore("epoch_1", init_train_state(ref, make_optimizer(ref.parameters(), hp)))
    x, y = _batch()
    rstate, loss = make_train_step(hp, 100, "BCE")(rstate, {"x": torch.from_numpy(x),
                                                            "y": torch.from_numpy(y)})
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    for k, p in ref.named_parameters():
        np.testing.assert_allclose(got["after"][k], p.detach().numpy(), rtol=1e-5, atol=2e-5,
                                   err_msg=k)


def test_data_and_tensor_parallel_bundles_predict_as_one_process():
    import torch

    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.parallel.launch import spawn
    from aum_tpu_torch.serving import export_bundle, load_bundle

    kw = _port_kw("v1")
    x = _batch()[0][:3]  # padded to the exported size 8, split over 2 ranks
    model = AudioMamba(AudioMambaConfig(**kw), device="cpu", seed=SEED)
    with torch.no_grad():
        want = load_bundle(export_bundle(model, audio_length=64, melbins=32,
                                         batch_sizes=(2, 8)), device="cpu").predict(x).numpy()
    got = spawn("aum_tpu_torch.parallel.checks:serve_leg", 2,
                dict(config=kw, seed=SEED, x=x, device="cpu"), backend="gloo", device="cpu")[0]
    assert [g["manifest"] for g in got] == [
        {"n_devices": 2, "data_axis": "data", "mesh_shape": {"data": 2, "model": 1},
         "model_axis": None},
        {"n_devices": 2, "data_axis": "data", "mesh_shape": {"data": 1, "model": 2},
         "model_axis": "model"}]
    for g in got:
        np.testing.assert_allclose(g["logits"], want, atol=1e-5, rtol=1e-5)
    assert got[0]["counts"]["bytes"]["serve_gather"] > 0
    assert got[1]["counts"]["bytes"]["tp_out"] > 0


@pytest.mark.parametrize("bimamba", ["v1", "v2"])
def test_every_d_inner_leaf_is_model_sharded(bimamba):
    """Shape-driven, as tests/test_tp_layout.py for JAX: every mixer leaf
    axis of size d_inner is the sharded one, and nothing else is."""
    from aum_tpu_torch.parallel import param_partition_specs

    kw = _port_kw(bimamba)
    sd = _port_sd(kw)
    d_inner = 2 * kw["embed_dim"]
    specs = param_partition_specs(sd)
    n_sharded = 0
    for k, v in sd.items():
        spec = specs[k]
        if ".mixer." not in k:
            assert spec.dim is None, k
            continue
        for axis, size in enumerate(v.shape):
            if size in (d_inner, 2 * d_inner):
                assert spec.dim == axis, (k, spec)
                n_sharded += 1
        if spec.dim is not None:
            assert v.shape[spec.dim] in (d_inner, 2 * d_inner), (k, spec)
        assert (spec.blocks == 2) == k.endswith("in_proj.weight"), k
    # Per mixer: in_proj, conv w+b, x_proj, dt_proj w+b, A_log, D, out_proj
    # and A_b_log (10); v2's second branch adds conv w+b, x_proj, dt_proj
    # w+b and D_b (16).
    assert n_sharded == kw["depth"] * (16 if bimamba == "v2" else 10)


@pytest.mark.parametrize("train,weights", [(True, False), (True, True), (False, False)],
                         ids=["train", "balanced", "eval"])
def test_data_order_per_rank_is_jaxs_process_slice(monkeypatch, train, weights):
    import aum_tpu.data.pipeline as jpipe
    from aum_tpu_torch.data.pipeline import BatchPipeline

    n = 23
    w = np.random.default_rng(0).random(n) if weights else None
    for rank in range(3):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: 3)
        base = dict(seed=5, dataset=[None] * n, train=train, weights=w, batch_size=4,
                    _drop_last=train)
        want = jpipe.BatchPipeline._epoch_order(types.SimpleNamespace(**base), 2)
        port = types.SimpleNamespace(**base, n_data=3, data_rank=rank)
        np.testing.assert_array_equal(BatchPipeline._epoch_order(port, 2), want)
        assert (BatchPipeline.steps_per_epoch(port)
                == jpipe.BatchPipeline.steps_per_epoch(types.SimpleNamespace(**base)))


def test_dryrun_multichip_4(capsys):
    from aum_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(4, device="cpu")
    assert out["mesh"] == {"data": 2, "model": 2} and np.isfinite(out["loss"])
    assert "loss3" not in out  # JAX's condition: the 3D and PP legs need n % 8 == 0
    assert capsys.readouterr().out.startswith(
        "dryrun_multichip(4): mesh={'data': 2, 'model': 2}, loss=")


def test_no_port_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "aum_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax", "aum_tpu"), (path, name)


def test_mesh_must_cover_the_world_and_nccl_needs_a_card_per_rank():
    from aum_tpu_torch.parallel import make_mesh
    from aum_tpu_torch.parallel.multihost import check_backend

    assert make_mesh().shape == {"data": 1, "pipe": 1, "seq": 1, "model": 1}
    with pytest.raises(ValueError, match="does not cover the world of 1"):
        make_mesh(n_model=2)
    with pytest.raises(ValueError, match="NCCL needs a card per rank"):
        check_backend("nccl", 2)
    check_backend("gloo", 4)


def test_pipe_and_seq_axes_cannot_be_combined():
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    with pytest.raises(ValueError, match="cannot be combined"):
        AudioMamba(AudioMambaConfig(**_port_kw("v1")), device="cpu", seq_axis="seq",
                   pipe_axis="pipe")
