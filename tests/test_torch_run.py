"""The PyTorch port's eval, metrics, checkpoints and runner against the JAX package, on the CPU.

- ``train.metrics.calculate_stats`` against ``aum_tpu``'s (with sklearn, and
  with the numpy fallback on both sides), to 1e-12;
- ``train.evaluate`` against ``aum_tpu``'s on the same logits, through a
  stub eval step (no model runs);
- a checkpoint round trip (model, Adam state and counters) and
  ``average_params`` against ``aum_tpu``'s;
- the recipes, field for field;
- the slice as a whole: one augmented train step (SpecAugment, noise and
  roll) of a depth-2 model against ``aum_tpu``'s ``make_train_step``, on the
  JAX step's weights carried over by ``convert.state_dict_from_jax`` and on
  the values the JAX step draws;
- ``average_ensemble_views`` against ``aum_tpu``'s;
- ``train_loop``'s optional artifacts: the predictions and a profiler trace;
- ``run.main`` on SpeechCommands-like WAVs: ``train`` for 2 epochs, then
  ``eval``, ``eval_wa`` and ``eval_ensemble``, with their artifacts;
- ``run.main`` with ``model=ast``, each pretrained init (AST, AuM and
  ImageNet ViM checkpoints through the porters) and ``--run-type eval
  --ckpt x.pth``;
- each option the port does not have (the parallel modes) raising
  ``NotImplementedError``.

torch is imported inside the tests, as in the other port test modules.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.configs import RECIPES as JAX_RECIPES
from aum_tpu.convert.torch_port import port_aum_state_dict
from aum_tpu.train import metrics as jax_metrics
from aum_tpu.train.checkpoints import average_params as jax_average_params
from aum_tpu.train.loop import average_ensemble_views as jax_average_ensemble_views
from aum_tpu.train.loop import evaluate as jax_evaluate
from scripts.record_goldens import build_flax
from test_runner import spc_like_data  # noqa: F401  (the fixture)
from test_torch_augment import jax_noise_draws, jax_spec_augment_draws
from test_torch_train import _max_rel, _recording


def _scores(seed, n=40, c=6):
    rng = np.random.default_rng(seed)
    y = (rng.random((n, c)) < 0.3).astype(np.float32)
    y[np.arange(n), rng.integers(0, c, n)] = 1.0
    y[:, 5] = 0.0  # a class with no positive: AUC is nan
    return rng.random((n, c)).astype(np.float32), y


@pytest.mark.parametrize("sklearn", [True, False], ids=["sklearn", "numpy"])
def test_calculate_stats_matches_jax(monkeypatch, sklearn):
    from aum_tpu_torch.train import metrics

    if not sklearn:
        monkeypatch.setattr(metrics, "_skm", None)
        monkeypatch.setattr(jax_metrics, "_skm", None)
    out, y = _scores(1)
    got = metrics.calculate_stats(out, y, full_curves=True)
    want = jax_metrics.calculate_stats(out, y, full_curves=True)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12, err_msg=k)
    assert np.isnan(got[5]["auc"])
    assert metrics.d_prime(0.8) == pytest.approx(jax_metrics.d_prime(0.8), abs=1e-12)
    assert metrics.mean_average_precision(out, y) == pytest.approx(
        jax_metrics.mean_average_precision(out, y), abs=1e-12)


@pytest.mark.parametrize("loss,main,nan2num", [("BCE", "mAP", False), ("CE", "acc", True)])
def test_evaluate_matches_jax(loss, main, nan2num):
    import torch

    from aum_tpu_torch.train import evaluate

    logits, y = _scores(2)
    logits = (logits - 0.5) * 8
    if nan2num:
        logits[3, 1] = np.nan
    batches = [(logits[i:i + 16], y[i:i + 16]) for i in range(0, len(y), 16)]
    want = jax_evaluate(lambda params, x: x, None, [{"x": a, "y": b} for a, b in batches],
                        loss, main, nan2num=nan2num, return_stats=True, full_curves=True)
    got = evaluate(lambda x: x, [{"x": torch.from_numpy(a), "y": torch.from_numpy(b)}
                                 for a, b in batches],
                   loss, main, nan2num=nan2num, return_stats=True, full_curves=True)
    assert set(got[0]) == set(want[0])
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=1e-12, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-7)  # fp32 sigmoid scores
    np.testing.assert_array_equal(got[2], want[2])
    assert len(got[3]) == len(want[3])


def _tiny(seed=21, **kw):
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    cfg = AudioMambaConfig(spectrogram_size=(32, 64), depth=2, embed_dim=32, num_classes=5,
                           bimamba_type="v1", **kw)
    return AudioMamba(cfg, device="cpu", seed=seed)


def test_checkpoint_round_trip_and_average_params(tmp_path):
    import torch

    from aum_tpu_torch.train import (
        Checkpointer,
        TrainHyperParams,
        average_params,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    hp = TrainHyperParams(lr=1e-3, warmup=False)
    model = _tiny()
    state = init_train_state(model, make_optimizer(model.parameters(), hp))
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn((2, 64, 32), generator=g), "y": torch.eye(5)[:2]}
    state, _ = make_train_step(hp, 10, "BCE")(state, batch)
    state.nonfinite_count = 3
    ck = Checkpointer(str(tmp_path / "models"))
    ck.save_best(state, 1, {"mAP": 0.5, "curve": [1, 2]})
    ck.save_latest(state, 1, {"mAP": 0.5})
    state, _ = make_train_step(hp, 10, "BCE")(state, batch)
    ck.save_latest(state, 2, {"mAP": 0.25})
    assert ck.available_epochs() == [1, 2]
    assert sorted(os.listdir(ck.directory)) == ["best", "best.json", "epoch_1", "epoch_2",
                                                "latest.json"]
    assert json.load(open(tmp_path / "models" / "best.json")) == {"epoch": 1,
                                                                  "metrics": {"mAP": 0.5}}
    assert json.load(open(tmp_path / "models" / "latest.json"))["epoch"] == 2

    fresh_model = _tiny(seed=5)
    fresh = init_train_state(fresh_model, make_optimizer(fresh_model.parameters(), hp))
    fresh = ck.restore("epoch_2", fresh)
    assert (fresh.step, fresh.nonfinite_count) == (2, 3)
    assert fresh.loss_sum == state.loss_sum
    for (k, a), b in zip(model.state_dict().items(), fresh_model.state_dict().values()):
        assert torch.equal(a, b), k
    want_opt, got_opt = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i, s in want_opt["state"].items():
        for k in s:
            assert torch.equal(s[k], got_opt["state"][i][k]), (i, k)
    # The restored state trains on as the original does.
    _, loss_a = make_train_step(hp, 10, "BCE")(state, batch)
    _, loss_b = make_train_step(hp, 10, "BCE")(fresh, batch)
    assert float(loss_a) == float(loss_b)

    sds = [ck.model_state(n) for n in ("best", "epoch_1", "epoch_2")]
    avg = average_params(sds)
    want = jax_average_params([{k: v.numpy() for k, v in sd.items()} for sd in sds])
    assert set(avg) == set(want)
    for k, v in avg.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_recipes_match_jax():
    from aum_tpu_torch.configs import RECIPES

    assert set(RECIPES) == set(JAX_RECIPES)
    for key, cfg in RECIPES.items():
        jcfg = JAX_RECIPES[key]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), key
        mcfg, jm = cfg.model_config(), jcfg.model_config()
        for f in dataclasses.fields(mcfg):
            if f.name not in ("remat", "remat_mode"):  # the port's "split" is JAX's "auto" here
                assert getattr(mcfg, f.name) == getattr(jm, f.name), (key, f.name)
        for train in (True, False):
            assert dataclasses.asdict(cfg.audio_conf(train)) == dataclasses.asdict(
                jcfg.audio_conf(train))
        assert dataclasses.asdict(cfg.train_hp()) == dataclasses.asdict(jcfg.train_hp())


TINY = dict(spectrogram_size=(32, 64), depth=2, embed_dim=32, d_state=16, num_classes=5,
            bimamba_type="v1", remat=False)
AUGMENT = dict(freqm=8, timem=16, noise=True)


def test_augmented_train_step_matches_jax(monkeypatch):
    """The slice as a whole: SpecAugment, noise and roll, the forward, BCE,
    the backward and Adam, on the same weights and draws."""
    import torch

    from aum_tpu.train.loop import AugmentConfig as JaxAugment
    from aum_tpu.train.loop import TrainState as JaxState
    from aum_tpu.train.loop import make_train_step as jax_make_train_step
    from aum_tpu.train.optim import TrainHyperParams as JaxHP
    from aum_tpu.train.optim import make_optimizer as jax_make_optimizer

    from aum_tpu_torch.convert import state_dict_from_jax
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.train import (
        AugmentConfig,
        TrainHyperParams,
        init_train_state,
        loop,
        make_optimizer,
        make_train_step,
    )

    hp = dict(lr=1e-3, weight_decay=1e-2, warmup=False)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 64, 32)) * 0.5).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[np.arange(4) % 5]
    jcfg, jmodel = build_flax(TINY)
    # JAX params from a seeded port model by the JAX package's porter (no
    # JAX init to compile); the port's model then takes them back through
    # state_dict_from_jax.
    seeded = AudioMamba(AudioMambaConfig(**TINY), device="cpu", seed=3)
    params = port_aum_state_dict({k: v.numpy() for k, v in seeded.state_dict().items()}, jcfg)
    tx = _recording(jax_make_optimizer(JaxHP(**hp), steps_per_epoch=100))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                      loss_sum=jnp.zeros((), jnp.float32),
                      nonfinite_count=jnp.zeros((), jnp.int32))
    jstep = jax_make_train_step(jmodel, tx, None, "BCE", JaxAugment(**AUGMENT), donate=False)
    key = jax.random.PRNGKey(9)
    jstate, jloss = jstep(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, key)
    want_grads = state_dict_from_jax(jax.device_get(jstate.opt_state[0]),
                                     AudioMambaConfig(**TINY))
    want_params = state_dict_from_jax(jax.device_get(jstate.params), AudioMambaConfig(**TINY))

    # The JAX step's draws: k_aug for SpecAugment, k_noise for the noise.
    k_aug, k_noise = jax.random.split(key)
    draws = {"spec_augment": jax_spec_augment_draws(k_aug, x.shape, 8, 16),
             "noise": jax_noise_draws(k_noise, x.shape)}
    monkeypatch.setattr(loop, "draw_augment", lambda g, shape, freqm, timem, noise: draws)
    model = AudioMamba(AudioMambaConfig(**TINY), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, model.config))
    state = init_train_state(model, make_optimizer(model.parameters(), TrainHyperParams(**hp)))
    grads, step_opt = {}, state.optimizer.step

    def recording_step(*a, **k):  # the grads as Adam receives them
        grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        return step_opt(*a, **k)

    state.optimizer.step = recording_step
    step = make_train_step(TrainHyperParams(**hp), 100, "BCE", AugmentConfig(**AUGMENT),
                           aug_generator=torch.Generator())
    state, loss = step(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    # fp32 on both sides; reduction orders differ.
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    mixer = [k for k in want_grads if ".mixer." in k]
    assert len(mixer) == 2 * 10 and set(grads) == set(want_grads)
    for k in mixer:
        # Each grad within 1e-4 of its tensor's largest element.
        assert _max_rel(grads[k].numpy(), want_grads[k].numpy()) <= 1e-4, k
    for k, p in model.named_parameters():
        # Adam's first step moves each param by about lr: see
        # test_torch_train.py::test_two_train_steps_match_jax.
        np.testing.assert_allclose(p.detach().numpy(), want_params[k].numpy(), rtol=1e-5,
                                   atol=2e-5, err_msg=k)


def _spc_common(data):
    return ["--recipe", "speechcommands/aum-base_scratch", "--label-csv", data["csv"],
            "--device", "cpu", "--num-workers", "2",
            "--set", "depth=2", "--set", "n_class=4", "--set", "batch_size=8",
            "--set", "model_type=tiny", "--set", "dtype=float32"]


def test_run_main_train_eval_wa_ensemble(spc_like_data, tmp_path, capsys):  # noqa: F811
    from aum_tpu_torch.run import main

    common = _spc_common(spc_like_data)
    exp = tmp_path / "exp"
    history = main(common + ["--data-train", spc_like_data["train"],
                             "--data-val", spc_like_data["valid"],
                             "--data-eval", spc_like_data["eval"],
                             "--exp-dir", str(exp), "--set", "n_epochs=2"])
    assert [h["epoch"] for h in history] == [1, 2]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["loss"]) for h in history)
    assert sorted(os.listdir(exp)) == ["config.json", "models", "progress.json", "result.csv",
                                       "stats_1.pickle", "stats_2.pickle"]
    assert sorted(os.listdir(exp / "models")) == ["best", "best.json", "epoch_1", "epoch_2",
                                                  "latest.json"]
    assert json.load(open(exp / "config.json"))["noise"] is True
    rows = open(exp / "result.csv").read().splitlines()
    assert rows[0] == "epoch,mAP,AUC,acc,d_prime,loss,train_loss" and len(rows) == 3
    progress = json.load(open(exp / "progress.json"))
    assert [p[:2] for p in progress] == [[1, 2], [2, 4]]  # 16 clips at B=8: 2 steps an epoch
    with open(exp / "stats_2.pickle", "rb") as f:
        assert len(pickle.load(f)) == 4
    out = capsys.readouterr().out
    assert "evaluate on the valid set" in out and "evaluate on the eval set" in out

    ckpt = str(exp / "models")
    ev = tmp_path / "ev"
    metrics = main(common + ["--data-eval", spc_like_data["eval"], "--exp-dir", str(ev),
                             "--run-type", "eval", "--ckpt", ckpt])
    assert 0.0 <= metrics["acc"] <= 1.0
    assert sorted(os.listdir(ev)) == ["config.json", "predictions_eval.csv", "result_eval.csv",
                                      "stats_eval.pickle"]
    result = np.loadtxt(ev / "result_eval.csv", delimiter=",")
    assert result.shape == (6,) and result[0] == metrics["acc"]
    assert np.loadtxt(ev / "predictions_eval.csv", delimiter=",").shape == (8, 4)
    # The best checkpoint's val accuracy, read back from its metadata.
    best = json.load(open(exp / "models" / "best.json"))
    val = main(common + ["--data-val", spc_like_data["valid"], "--exp-dir", str(tmp_path / "v"),
                         "--run-type", "eval", "--ckpt", ckpt])
    assert val["acc"] == best["metrics"]["acc"]

    capsys.readouterr()
    wa = main(common + ["--data-eval", spc_like_data["eval"], "--exp-dir", str(tmp_path / "wa"),
                        "--run-type", "eval_wa", "--ckpt", ckpt])
    assert 0.0 <= wa["acc"] <= 1.0 and '"n_models": 2' in capsys.readouterr().out
    main(common + ["--data-eval", spc_like_data["eval"], "--exp-dir", str(tmp_path / "wa2"),
                   "--run-type", "eval_wa", "--ckpt", ckpt, "--wa-start", "2", "--wa-end", "2"])
    assert '"n_models": 1' in capsys.readouterr().out
    ens = main(common + ["--data-eval", spc_like_data["eval"], "--exp-dir", str(tmp_path / "en"),
                         "--run-type", "eval_ensemble", "--ckpt", ckpt])
    assert [r["n_models"] for r in ens] == [1, 2] and "acc" in ens[0]

    # Resume from the newest epoch checkpoint: a 3-epoch run trains epoch 3.
    res = tmp_path / "resume"
    history = main(common + ["--data-train", spc_like_data["train"],
                             "--data-val", spc_like_data["valid"], "--exp-dir", str(res),
                             "--set", "n_epochs=3", "--ckpt", ckpt])
    assert [h["epoch"] for h in history] == [3]
    assert json.load(open(res / "progress.json"))[0][:2] == [3, 6]
    assert os.path.exists(res / "stats_3.pickle") and not os.path.exists(res / "stats_1.pickle")


@pytest.mark.parametrize("extra", [["--n-model", "2"], ["--n-seq", "2"], ["--n-pipe", "2"],
                                   ["--multihost", "on"]],
                         ids=["n_model", "n_seq", "n_pipe", "multihost"])
def test_run_main_raises_on_unported_options(tmp_path, monkeypatch, extra):
    """The parallel options are ported: in one process without a rendezvous
    each raises before anything is written. A mesh axis of 2 does not cover
    the world of one process (the mesh's ValueError, as JAX's ``make_mesh``
    asserts); ``--multihost on`` finds no torchrun environment to start
    from. ``tests/test_torch_parallel.py`` runs them on several ranks."""
    from aum_tpu_torch.run import main

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    argv = ["--recipe", "as20k/aum-base_scratch", "--exp-dir", str(tmp_path), "--device", "cpu",
            "--label-csv", "labels.csv"] + extra
    match = "MASTER_ADDR" if extra[0] == "--multihost" else "does not cover the world of 1"
    with pytest.raises(ValueError, match=match):
        main(argv)
    assert not os.listdir(tmp_path)


def _reference_checkpoint(tmp_path, case, sets):
    """A random reference checkpoint for ``case`` (a ``.pth`` path) and the
    patch kernel the model must take from it."""
    import torch

    from aum_tpu_torch.configs import RECIPES
    from aum_tpu_torch.convert import export_ast_state_dict, save_reference_checkpoint
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.models.ast import ASTModel
    from aum_tpu_torch.run import apply_overrides, ast_config

    cfg = apply_overrides(RECIPES["speechcommands/aum-base_scratch"], sets)
    path = str(tmp_path / f"{case}.pth")
    if case == "ast":  # an AST audio checkpoint at the pretrain grid (8, 3)
        pre = dataclasses.replace(ast_config(cfg), fstride=16, tstride=16, input_tdim=64)
        sd = export_ast_state_dict(ASTModel(pre, device="cpu", seed=5))
        torch.save({"module." + k: v for k, v in sd.items()}, path)
        return path, sd["v.patch_embed.proj.weight"]
    if case == "imagenet":  # a ViM on a 4 x 4 image grid, under "model"
        from test_torch_porters import _vim_checkpoint

        vim_path, vim = _vim_checkpoint(tmp_path, dict(cfg.model_config().__dict__), side=4)
        return vim_path, torch.from_numpy(vim["patch_embed.proj.weight"]).mean(1, keepdim=True)
    # An AuM: AudioSet's 1024 x 128 grid and 527 classes (pretrain), or this
    # recipe's own (pth).
    mcfg = cfg.model_config()
    if case == "pretrain":
        mcfg = dataclasses.replace(mcfg, spectrogram_size=(128, 1024), num_classes=527)
    donor = AudioMamba(mcfg, device="cpu", seed=6)
    save_reference_checkpoint(donor, path)
    return path, donor.patch_embed.proj.weight.detach().clone()


@pytest.mark.parametrize("case", ["ast", "pretrain", "imagenet", "pth"])
def test_run_main_runs_ast_pretrained_inits_and_pth(spc_like_data, tmp_path, case):  # noqa: F811
    """What the runner refused before the porters and AST were ported: one
    train step (16 clips at B=16) and the validation of ``model=ast`` from
    an AST audio checkpoint, of an AuM from an AudioSet AuM checkpoint
    (grid (8, 64) -> (8, 8), head dropped) and of a Bi-Bi AuM from an
    ImageNet ViM; and ``--run-type eval --ckpt x.pth``, whose predictions
    must be those of the same weights drawn in-process."""
    import torch

    from aum_tpu_torch.configs import RECIPES
    from aum_tpu_torch.run import apply_overrides, build_model, main

    common = _spc_common(spc_like_data)
    sets = ["depth=2", "n_class=4", "batch_size=16", "model_type=tiny", "dtype=float32"]
    init = {"ast": ["model=ast", "fstride=10", "tstride=10", "ast_pretrain_input_tdim=64"],
            "pretrain": [], "imagenet": ["aum_type=Bi-Bi"], "pth": []}[case]
    path, kernel = _reference_checkpoint(tmp_path, case, sets + init)
    init += {"ast": ["ast_pretrain_path=" + path], "pretrain": ["aum_pretrain_path=" + path],
             "imagenet": ["imagenet_pretrain_path=" + path], "pth": []}[case]
    argv = common + [a for s in ["batch_size=16"] + init for a in ("--set", s)]
    if case == "pth":
        exp = tmp_path / "ev"
        metrics = main(argv + ["--data-eval", spc_like_data["eval"], "--exp-dir", str(exp),
                               "--run-type", "eval", "--ckpt", path])
        same = main(argv + ["--data-eval", spc_like_data["eval"], "--exp-dir", str(tmp_path / "s"),
                            "--run-type", "eval", "--set", "seed=6"])
        assert metrics == same and 0.0 <= metrics["acc"] <= 1.0
        np.testing.assert_array_equal(np.loadtxt(exp / "predictions_eval.csv", delimiter=","),
                                      np.loadtxt(tmp_path / "s" / "predictions_eval.csv",
                                                 delimiter=","))
        return
    model = build_model(apply_overrides(RECIPES["speechcommands/aum-base_scratch"], sets + init),
                        "cpu")
    got = model.v.patch_embed.proj.weight if case == "ast" else model.patch_embed.proj.weight
    assert torch.equal(got.detach(), kernel)
    history = main(argv + ["--data-train", spc_like_data["train"], "--data-val",
                           spc_like_data["valid"], "--exp-dir", str(tmp_path / "exp"),
                           "--set", "n_epochs=1"])
    assert [h["epoch"] for h in history] == [1]
    assert np.isfinite(history[0]["train_loss"]) and np.isfinite(history[0]["loss"])
    assert json.load(open(tmp_path / "exp" / "progress.json"))[0][:2] == [1, 1]


def test_train_loop_raises_on_a_nonfinite_loss_unless_continue_inf():
    import torch

    from aum_tpu_torch.train import TrainHyperParams, init_train_state, make_optimizer, train_loop

    model = _tiny()
    state = init_train_state(model, make_optimizer(model.parameters(), TrainHyperParams()))
    nan = {"x": torch.full((2, 64, 32), float("nan")), "y": torch.eye(5)[:2]}
    with pytest.raises(RuntimeError, match="non-finite train loss"):
        train_loop(state, TrainHyperParams(), 1, lambda e: [nan], lambda: [], 1,
                   continue_inf=False)


def test_average_ensemble_views_matches_jax():
    from aum_tpu_torch.train import average_ensemble_views

    rng = np.random.default_rng(3)
    scores = rng.random((12, 4)).astype(np.float32)
    record = rng.permutation(np.repeat(np.array([7, 2, 9]), 4))
    got, want = average_ensemble_views(scores, record), jax_average_ensemble_views(scores, record)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], [2, 7, 9])


def test_train_loop_writes_predictions_and_a_trace(tmp_path):
    import torch

    from aum_tpu_torch.train import (
        TrainHyperParams,
        init_train_state,
        make_optimizer,
        sigmoid_np,
        train_loop,
    )

    model = _tiny()
    state = init_train_state(model, make_optimizer(model.parameters(), TrainHyperParams()))
    g = torch.Generator().manual_seed(0)
    train = [{"x": torch.randn((2, 64, 32), generator=g), "y": torch.eye(5)[i:i + 2]}
             for i in range(3)]
    val = [{"x": torch.randn((3, 64, 32), generator=g), "y": torch.eye(5)[:3]}]
    printed = []
    train_loop(state, TrainHyperParams(), 3, lambda e: train, lambda: val, 2,
               exp_dir=str(tmp_path), save_predictions=True,
               profile_dir=str(tmp_path / "prof"), profile_steps=(1, 2), print_fn=printed.append)
    pdir = tmp_path / "predictions"
    assert sorted(os.listdir(pdir)) == ["predictions_1.csv", "predictions_2.csv", "target.csv"]
    np.testing.assert_array_equal(np.loadtxt(pdir / "target.csv", delimiter=","), np.eye(5)[:3])
    # The last epoch's scores: the trained model's sigmoided logits.
    with torch.inference_mode():
        want = sigmoid_np(model(val[0]["x"]).float().numpy())
    np.testing.assert_array_equal(np.loadtxt(pdir / "predictions_2.csv", delimiter=","), want)
    assert json.load(open(tmp_path / "prof" / "trace.json"))["traceEvents"]
    assert sum("profiler trace (steps 1-2)" in m for m in printed) == 1
