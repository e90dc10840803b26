"""The port's user tools (``aum_tpu_torch/scripts/``) against the JAX
package's scripts (``scripts/``), on the CPU, through each one's ``main``.

The same inputs, made from seeds with numpy, go to both: WAV clips and a
label CSV written under a temporary directory, reference-layout ``.pth``
files exported from the port's seeded models (both packages' porters read
them), an HF-format LM directory. The JAX models run through their plain
references (``use_kernel=False``, as ``tests/test_ref_parity.py`` builds
them), so no Pallas kernel is compiled in interpret mode; the scripts that
take no ``argv`` get theirs through ``sys.argv``.

- ``infer``: the top-k names equal and the scores within 2e-3 + 2e-3·|ref|
  (the printed 4 decimals), from a ``.pth`` and from a run's checkpoint
  directory; no ``--wav`` and no upstream sample is an error;
- ``verify_ckpt``: the recorded logits (2e-3 + 2e-3·|ref|) and inputs
  (1e-4 + 1e-4·|x|), the port verifying JAX's golden file, the raw
  ``--features`` clips (1e-4 + 1e-4·|x|) and the port checking JAX's
  recording;
- ``verify_lm``: the logits (2e-5, fp32) and the port verifying JAX's
  golden; a hub id in a hub-cache layout (``HF_HUB_CACHE``) gives the same
  logits as the directory, and the port's ``from_pretrained_hf`` on it is
  bit-equal to the JAX loader's on the same id (run in a subprocess:
  transformers reads ``HF_HUB_CACHE`` when it is imported); the cache root's
  lookup order; an id not in the cache raises ``FileNotFoundError``;
- ``get_norm_stats``: ``mean`` and ``std`` within 1e-5, with and without
  ``--batches``;
- ``gen_weight_file``: the CSV equal;
- ``export_torch_ckpt``: the ``.pth`` bit-equal to JAX's exporter's on the
  same weights (an orbax directory of the JAX tree the JAX porter makes);
- every tool's default device is the card: without one it raises.
"""

import functools
import json
import os
import re
import subprocess
import sys
import wave as wave_mod

import numpy as np
import pytest

import aum_tpu.models as jax_models
import aum_tpu.models.lm as jax_lm

LABELS = [f"/m/c{i}" for i in range(5)]
INFER_SETS = ["model_type=tiny", "depth=2", "dtype=float32", "audio_length=64", "melbins=32",
              "n_class=5"]
CKPT_ARGS = ["--model-type", "tiny", "--aum-type", "Fo-Bi", "--n-class", "5",
             "--audio-length", "32", "--melbins", "32"]
LM_CONFIG = {"d_model": 64, "n_layer": 2, "vocab_size": 100, "d_state": 8, "ssm_cfg": {},
             "rms_norm": True, "residual_in_fp32": True, "fused_add_norm": True,
             "pad_vocab_size_multiple": 8}
FP32_TOL = dict(atol=2e-3, rtol=2e-3)
FEATURE_TOL = dict(atol=1e-4, rtol=1e-4)


def _write_wav(path, samples, sr=16000):
    data = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    with wave_mod.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seven clips of 0.3-1.0 s at 16 kHz (tones in noise), a 5-class label
    CSV and a multi-label manifest."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(0)
    entries = []
    for i in range(7):
        n = int(16000 * (0.3 + 0.1 * i))
        t = np.arange(n) / 16000
        samples = 0.05 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * (200 + 300 * i) * t)
        path = root / f"clip{i}.wav"
        _write_wav(path, samples)
        labels = [LABELS[i % 5]] + ([LABELS[(i + 2) % 5]] if i % 3 == 0 else [])
        entries.append({"wav": str(path), "labels": ",".join(labels)})
    manifest = root / "data.json"
    manifest.write_text(json.dumps({"data": entries}))
    csv = root / "labels.csv"
    csv.write_text("index,mid,display_name\n" + "\n".join(
        f"{i},{m},name {i}" for i, m in enumerate(LABELS)))
    return {"root": root, "wavs": [e["wav"] for e in entries], "manifest": str(manifest),
            "csv": str(csv)}


@pytest.fixture()
def plain_jax(monkeypatch):
    """The JAX scripts' models on their plain references."""
    monkeypatch.setattr(jax_models, "AudioMamba",
                        functools.partial(jax_models.AudioMamba, use_kernel=False))
    import dataclasses

    orig = jax_lm.MambaLM
    monkeypatch.setattr(jax_lm, "MambaLM",
                        lambda cfg: orig(dataclasses.replace(cfg, use_kernel=False)))


def _jax_main(monkeypatch, module, argv):
    """A JAX script's ``main``, with ``argv`` through ``sys.argv`` when it
    takes none."""
    import importlib
    import inspect

    main = importlib.import_module(f"scripts.{module}").main
    if inspect.signature(main).parameters:
        return main(argv)
    monkeypatch.setattr(sys, "argv", [module, *argv])
    return main()


def _port_main(module, argv):
    import importlib

    return importlib.import_module(f"aum_tpu_torch.scripts.{module}").main(argv)


def _save_aum_pth(path, cfg, seed, prefix="module."):
    """A reference-layout ``.pth`` of the port's seeded AudioMamba."""
    import torch

    from aum_tpu_torch.convert import export_aum_state_dict
    from aum_tpu_torch.models import AudioMamba

    model = AudioMamba(cfg, device="cpu", seed=seed)
    torch.save({prefix + k: v for k, v in export_aum_state_dict(model).items()}, str(path))
    return model


def _topk_lines(text):
    out = []
    for line in text.splitlines():
        m = re.fullmatch(r"(.+): (-?[0-9.]+)", line)
        if m and not line.startswith("#"):
            out.append((m.group(1), float(m.group(2))))
    return out


def test_infer_matches_the_jax_script(data, tmp_path, monkeypatch, capsys, plain_jax):
    """A ``.pth`` and a run's checkpoint directory holding the same weights:
    both give the JAX script's top-k."""
    import torch

    from aum_tpu_torch.configs import RECIPES
    from aum_tpu_torch.run import apply_overrides

    cfg = apply_overrides(RECIPES["audioset/aum-base_scratch"], INFER_SETS)
    pth = tmp_path / "aum.pth"
    model = _save_aum_pth(pth, cfg.model_config(), seed=3)
    models_dir = tmp_path / "models"
    models_dir.mkdir()
    torch.save({"model": model.state_dict()}, str(models_dir / "best"))
    args = ["--wav", data["wavs"][4], "--label-csv", data["csv"], "--topk", "3"]
    for s in INFER_SETS:
        args += ["--set", s]
    capsys.readouterr()
    _jax_main(monkeypatch, "infer", args + ["--ckpt", str(pth)])
    want = _topk_lines(capsys.readouterr().out)
    assert len(want) == 3
    for ckpt in (str(pth), str(models_dir)):
        assert _port_main("infer", args + ["--ckpt", ckpt, "--device", "cpu"]) == 0
        got = _topk_lines(capsys.readouterr().out)
        assert [n for n, _ in got] == [n for n, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], **FP32_TOL)
    # Random init announces itself; no --wav and no upstream sample is an error.
    assert _port_main("infer", args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("# no --ckpt: random-init model")
    monkeypatch.setenv("AUM_REFERENCE_PATH", str(tmp_path / "absent"))
    with pytest.raises(SystemExit):
        _port_main("infer", ["--device", "cpu"])
    assert "--wav is required" in capsys.readouterr().err


def test_verify_ckpt_matches_the_jax_script(data, tmp_path, capsys, plain_jax):
    """record, verify (the port against JAX's golden), topk, --features
    (the port against JAX's recording) and --fbank-npz."""
    import argparse

    from aum_tpu_torch.scripts.verify_ckpt import model_config

    ns = argparse.Namespace(model_type="tiny", aum_type="Fo-Bi", n_class=5, melbins=32,
                            audio_length=32)
    pth = tmp_path / "tiny.pth"
    _save_aum_pth(pth, model_config(ns), seed=4)
    args = ["--ckpt", str(pth), *CKPT_ARGS, "--wav", *data["wavs"][:3], "--label-csv",
            data["csv"], "--topk", "2"]
    jg, jf = str(tmp_path / "jax_golden.npz"), str(tmp_path / "jax_features.npz")
    pg, pf = str(tmp_path / "port_golden.npz"), str(tmp_path / "port_features.npz")
    from scripts.verify_ckpt import main as jax_main

    assert jax_main(args + ["--record-to", jg, "--features-record-to", jf]) == 0
    capsys.readouterr()
    assert _port_main("verify_ckpt", args + ["--device", "cpu", "--record-to", pg, "--golden",
                                             jg, "--features", jf, "--features-record-to",
                                             pf]) == 0
    out = capsys.readouterr().out
    assert "PARITY OK" in out and "FEATURES PARITY OK" in out and "clip 2: " in out
    j, p = np.load(jg), np.load(pg)
    np.testing.assert_allclose(p["x"], j["x"], **FEATURE_TOL)
    np.testing.assert_allclose(p["logits"], j["logits"], **FP32_TOL)
    jfe, pfe = np.load(jf), np.load(pf)
    assert sorted(jfe.files) == sorted(pfe.files) == ["clip_000", "clip_001", "clip_002"]
    for k in jfe.files:
        np.testing.assert_allclose(pfe[k], jfe[k], **FEATURE_TOL)
    # Its own recording round-trips; JAX's recorded inputs give its logits.
    base = ["--ckpt", str(pth), *CKPT_ARGS, "--device", "cpu"]
    assert _port_main("verify_ckpt", base + ["--wav", *data["wavs"][:3], "--golden", pg]) == 0
    assert _port_main("verify_ckpt", base + ["--fbank-npz", jg, "--golden", jg]) == 0
    assert _port_main("verify_ckpt", ["--device", "cpu", "--melbins", "32", "--wav",
                                      *data["wavs"][:3], "--features", jf]) == 0


def _hf_dir(path, seed=1):
    import torch

    from aum_tpu_torch.models.lm import MambaLM, MambaLMConfig

    cfg = MambaLMConfig(**{k: LM_CONFIG[k] for k in ("d_model", "n_layer", "vocab_size",
                                                     "d_state", "pad_vocab_size_multiple")})
    model = MambaLM(cfg, device="cpu", seed=seed)
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(LM_CONFIG))
    sd = dict(model.state_dict())
    sd["lm_head.weight"] = sd["backbone.embedding.weight"]
    torch.save(sd, str(path / "pytorch_model.bin"))
    return model


def _hub_cache(root, repo_id, files_from, commit="0123abcd"):
    """An HF hub cache under ``root`` holding ``files_from``'s two files."""
    import shutil

    repo = root / ("models--" + repo_id.replace("/", "--"))
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text(commit)
    snap = repo / "snapshots" / commit
    snap.mkdir(parents=True)
    for f in ("config.json", "pytorch_model.bin"):
        shutil.copy(files_from / f, snap / f)
    return root


def test_verify_lm_matches_the_jax_script_by_dir_and_hub_id(tmp_path, monkeypatch, capsys,
                                                             plain_jax):
    hf = tmp_path / "hf"
    _hf_dir(hf)
    jg, pg, ph = (str(tmp_path / f) for f in ("jax.npz", "port.npz", "port_hub.npz"))
    from scripts.verify_lm import main as jax_main

    assert jax_main(["--model", str(hf), "--record-to", jg]) == 0
    assert _port_main("verify_lm", ["--model", str(hf), "--device", "cpu", "--golden", jg,
                                    "--record-to", pg]) == 0
    assert "LM GOLDEN OK" in capsys.readouterr().out
    j, p = np.load(jg), np.load(pg)
    np.testing.assert_array_equal(p["tokens"], j["tokens"])
    np.testing.assert_allclose(p["logits"], j["logits"], rtol=2e-5, atol=2e-5)
    monkeypatch.setenv("HF_HUB_CACHE", str(_hub_cache(tmp_path / "hub", "org/tiny", hf)))
    assert _port_main("verify_lm", ["--model", "org/tiny", "--device", "cpu",
                                    "--record-to", ph]) == 0
    np.testing.assert_array_equal(np.load(ph)["logits"], p["logits"])


JAX_HUB_LOAD = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from aum_tpu.models.lm import from_pretrained_hf
params, cfg = from_pretrained_hf(sys.argv[1])
with open(sys.argv[2], "wb") as f:
    pickle.dump(jax.tree.map(np.asarray, params), f)
"""


def test_from_pretrained_hf_hub_id_matches_the_jax_loader(tmp_path, monkeypatch):
    """A hub id resolved in a hub-cache layout under ``HF_HUB_CACHE``: the
    port's model bit-equal to the JAX loader's tree on the same id (the JAX
    loader in a subprocess started with the variable set, offline)."""
    import pickle

    import torch

    from aum_tpu_torch.convert import lm_state_dict_from_jax
    from aum_tpu_torch.models.lm import from_pretrained_hf

    hf = tmp_path / "hf"
    _hf_dir(hf, seed=2)
    cache = _hub_cache(tmp_path / "hub", "org/tiny", hf)
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    model = from_pretrained_hf("org/tiny", device="cpu")
    out = tmp_path / "jax_params.pkl"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, HF_HUB_CACHE=str(cache), HF_HUB_OFFLINE="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=repo)
    subprocess.run([sys.executable, "-c", JAX_HUB_LOAD, "org/tiny", str(out)], env=env,
                   check=True, cwd=repo, timeout=300)
    with open(out, "rb") as f:
        params = pickle.load(f)
    want = lm_state_dict_from_jax(params, model.config)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        from_pretrained_hf("org/absent", device="cpu")


def test_hub_cache_dir_lookup_order(tmp_path, monkeypatch):
    from aum_tpu_torch.models.lm import hub_cache_dir

    for var in ("HF_HUB_CACHE", "HF_HOME", "XDG_CACHE_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert hub_cache_dir() == str(tmp_path / "home" / ".cache" / "huggingface" / "hub")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert hub_cache_dir() == str(tmp_path / "xdg" / "huggingface" / "hub")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    assert hub_cache_dir() == str(tmp_path / "hf_home" / "hub")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert hub_cache_dir() == str(tmp_path / "hub")


def _stats(text):
    m = re.search(r"mean=(-?[0-9.]+) std=(-?[0-9.]+)", text)
    return float(m.group(1)), float(m.group(2))


@pytest.mark.parametrize("batches", [[], ["--batches", "2"]], ids=["all", "batches_2"])
def test_get_norm_stats_matches_the_jax_script(data, monkeypatch, capsys, batches):
    args = ["--data", data["manifest"], "--label-csv", data["csv"], "--target-length", "64",
            "--melbins", "32", "--batch-size", "2", *batches]
    capsys.readouterr()
    _jax_main(monkeypatch, "get_norm_stats", args)
    want = _stats(capsys.readouterr().out)
    assert _port_main("get_norm_stats", args + ["--device", "cpu"]) == 0
    got = _stats(capsys.readouterr().out)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gen_weight_file_matches_the_jax_script(data, tmp_path, monkeypatch):
    args = ["--data", data["manifest"], "--label-csv", data["csv"]]
    _jax_main(monkeypatch, "gen_weight_file", args + ["--out", str(tmp_path / "jax.csv")])
    assert _port_main("gen_weight_file", args + ["--out", str(tmp_path / "port.csv"),
                                                 "--device", "cpu"]) == 0
    want = (tmp_path / "jax.csv").read_text()
    assert (tmp_path / "port.csv").read_text() == want and len(want.splitlines()) == 7


def test_export_torch_ckpt_matches_the_jax_exporter(tmp_path, monkeypatch):
    """The same weights as a port run's ``best`` and as an orbax directory of
    the JAX tree: the two exported ``.pth`` files are equal bit for bit."""
    import orbax.checkpoint as ocp
    import torch

    from aum_tpu.convert import torch_port as jax_port
    from aum_tpu.models import AudioMambaConfig as JaxConfig
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    kw = dict(num_classes=5, spectrogram_size=(32, 32))
    model = AudioMamba(AudioMambaConfig.from_variant("tiny", "Fo-Bi", **kw), device="cpu",
                       seed=6)
    models_dir = tmp_path / "models"
    models_dir.mkdir()
    torch.save({"model": model.state_dict(), "optimizer": {}, "step": 0, "loss_sum": 0.0,
                "nonfinite_count": 0}, str(models_dir / "epoch_3"))
    tree = jax_port.port_aum_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                        JaxConfig.from_variant("tiny", "Fo-Bi", **kw))
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "orbax" / "epoch_3"), tree)
    ckptr.wait_until_finished()
    args = ["--name", "epoch_3", *CKPT_ARGS]
    assert _jax_main(monkeypatch, "export_torch_ckpt",
                     args + ["--orbax", str(tmp_path / "orbax"),
                             "--out", str(tmp_path / "jax.pth")]) == 0
    assert _port_main("export_torch_ckpt", args + ["--ckpt-dir", str(models_dir), "--out",
                                                   str(tmp_path / "port.pth"),
                                                   "--device", "cpu"]) == 0
    want = torch.load(str(tmp_path / "jax.pth"), map_location="cpu", weights_only=True)
    got = torch.load(str(tmp_path / "port.pth"), map_location="cpu", weights_only=True)
    assert set(got) == set(want)  # the same keys; the port writes them in its module order
    for k, v in want.items():
        v = torch.as_tensor(v)
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _tool_argv(name, data, tmp_path):
    return {"infer": ["--wav", data["wavs"][0]],
            "verify_ckpt": ["--ckpt", str(tmp_path / "x.pth")],
            "verify_lm": ["--model", str(tmp_path)],
            "get_norm_stats": ["--data", data["manifest"], "--label-csv", data["csv"]],
            "gen_weight_file": ["--data", data["manifest"], "--label-csv", data["csv"],
                                "--out", str(tmp_path / "w.csv")],
            "export_torch_ckpt": ["--ckpt-dir", str(tmp_path), "--n-class", "5",
                                  "--out", str(tmp_path / "x.pth")]}[name]


@pytest.mark.parametrize("name", ["infer", "verify_ckpt", "verify_lm", "get_norm_stats",
                                  "gen_weight_file", "export_torch_ckpt"])
def test_tools_default_to_the_card(name, data, tmp_path, monkeypatch):
    """Without ``--device`` a tool runs on the CUDA card; without one (as
    here, and as it is made to look where there is one) it raises and does
    not fall back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port_main(name, _tool_argv(name, data, tmp_path))
