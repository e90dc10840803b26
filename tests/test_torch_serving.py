"""The PyTorch port's serving bundles (``serving.py``) against the JAX package's, on the CPU.

The JAX package's bundles (``export_bundle(..., platforms=("cpu",))``, then
``load_bundle``) are built once per module, from a JAX tree of the port's
seeded weights (carried by the JAX package's porter, no JAX init to
compile); the port's bundles take the same weights through
``convert.state_dict_from_jax``. Held to JAX's within fp32 1e-5:

- ``predict`` at a padded, an exact and a chunked batch, and from waveforms
  through the frontend;
- int8: the values and scales equal JAX's ``quantize_weights_int8`` (after
  the (in, out) -> (out, in) transpose), and the int8 bundle's logits;
  against the float logits within JAX's own int8 bound.

Also ``predict_scores`` (a sigmoid), the HTTP server on 127.0.0.1 (port 0)
(one client, then four at once, each answer bit-equal to a sequential
``predict_scores``),
an AST bundle (nothing quantized, as in JAX), ``python -m
aum_tpu_torch.serving export`` from a reference ``.pth``, the request-shape
check, and the multi-device arguments in one process (a one-rank mesh is
recorded; a larger one cannot be built). torch is
imported inside the tests, as in the other port test modules.
"""

import io
import json
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest

import jax

from aum_tpu import serving as jax_serving
from aum_tpu.convert.torch_port import port_aum_state_dict as jax_port_aum
from scripts.record_goldens import build_flax

TINY = dict(depth=2, embed_dim=64, spectrogram_size=(32, 64), patch_size=(16, 16),
            num_classes=10)
LABELS = [f"l{i}" for i in range(10)]
SR, WAV_SAMPLES = 16000, 12000  # 0.75 s clips: 73 frames, cropped to 64


@pytest.fixture(scope="module")
def tiny():
    """(port cfg, port model, JAX model, JAX params, JAX bundles by name)."""
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    cfg = AudioMambaConfig(**TINY)
    model = AudioMamba(cfg, device="cpu", seed=0)
    jcfg, jmodel = build_flax(TINY)
    params = jax_port_aum({k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    common = dict(audio_length=64, melbins=32, platforms=("cpu",))
    blobs = {
        "float": jax_serving.export_bundle(jmodel, params, batch_sizes=(2, 4), labels=LABELS,
                                           **common),
        "frontend": jax_serving.export_bundle(jmodel, params, batch_sizes=(2,), mean=-4.27,
                                              std=4.57, include_frontend=True, sample_rate=SR,
                                              wav_samples=WAV_SAMPLES, **common),
        "int8": jax_serving.export_bundle(jmodel, params, batch_sizes=(2,), weight_quant="int8",
                                          **common),
    }
    return cfg, model, jmodel, params, {k: jax_serving.load_bundle(v) for k, v in blobs.items()}


def _port_bundle(tiny, **kw):
    from aum_tpu_torch.convert import state_dict_from_jax
    from aum_tpu_torch.serving import export_bundle, load_bundle

    cfg, model, _, params, _ = tiny
    blob = export_bundle(model, state_dict_from_jax(params, cfg), audio_length=64, melbins=32,
                         **kw)
    return blob, load_bundle(blob, device="cpu")


def _x(seed, bsz):
    return np.random.default_rng(seed).standard_normal((bsz, 64, 32)).astype(np.float32)


@pytest.mark.parametrize("bsz", [3, 4, 9], ids=["pad", "exact", "chunk"])
def test_bundle_predict_matches_jax(tiny, bsz):
    blob, sm = _port_bundle(tiny, batch_sizes=(4, 2), labels=LABELS)
    assert sm.batch_sizes == [2, 4] and sm.labels[3] == "l3"
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        assert set(zf.namelist()) == {"manifest.json", "params.npz"}
        manifest = json.loads(zf.read("manifest.json"))
    jax_manifest = tiny[4]["float"].manifest
    assert set(jax_manifest) <= set(manifest) and manifest["model"]["kind"] == "aum"
    x = _x(bsz, bsz)
    got = sm.predict(x)
    want = np.asarray(tiny[4]["float"].predict(x))
    assert tuple(got.shape) == want.shape == (bsz, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_frontend_bundle_matches_jax(tiny):
    _, sm = _port_bundle(tiny, batch_sizes=(2,), mean=-4.27, std=4.57, include_frontend=True,
                         sample_rate=SR, wav_samples=WAV_SAMPLES)
    wav = (np.random.default_rng(4).standard_normal((2, WAV_SAMPLES)) * 0.1).astype(np.float32)
    want = np.asarray(tiny[4]["frontend"].predict(wav))
    np.testing.assert_allclose(sm.predict(wav).numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="takes"):
        sm.predict(wav[:, :100])


def test_int8_values_and_scales_equal_jax(tiny):
    import torch

    from aum_tpu_torch.convert import state_dict_from_jax
    from aum_tpu_torch.serving import quantize_weights_int8

    cfg, _, _, params, _ = tiny
    jq = jax_serving.quantize_weights_int8(params)
    quant = lambda x: jax_serving._is_quant_leaf(x)  # noqa: E731
    want = {part: state_dict_from_jax(jax.tree.map(lambda leaf: leaf[part] if quant(leaf)
                                                   else leaf, jq, is_leaf=quant), cfg)
            for part in ("int8", "scale")}
    got = quantize_weights_int8(state_dict_from_jax(params, cfg))
    quantized = {k for k, v in got.items() if isinstance(v, dict)}
    # The keys JAX quantized: those its int8 values changed.
    assert quantized == {k for k, v in want["int8"].items()
                         if not torch.equal(v, state_dict_from_jax(params, cfg)[k])}
    assert "head.weight" in quantized and "layers.1.mixer.in_proj.weight" in quantized
    for k in quantized:
        assert got[k]["int8"].dtype == torch.int8 and got[k]["scale"].shape[1:] == (1,)
        assert torch.equal(got[k]["int8"].float(), want["int8"][k]), k
        assert torch.equal(got[k]["scale"], want["scale"][k]), k


def test_int8_bundle_matches_jax(tiny):
    blob, sm = _port_bundle(tiny, batch_sizes=(2,), weight_quant="int8")
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        names = np.load(io.BytesIO(zf.read("params.npz"))).files
    assert "head.weight/int8" in names and "head.weight/scale" in names
    x = _x(7, 2)
    got = sm.predict(x).numpy()
    np.testing.assert_allclose(got, np.asarray(tiny[4]["int8"].predict(x)), rtol=1e-5,
                               atol=1e-5)
    # JAX's int8 bound against the float logits (tests/test_serving.py).
    want = np.asarray(tiny[4]["float"].predict(x))
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert np.all(cos > 0.99), cos
    assert np.max(np.abs(got - want)) < 0.35 * max(1.0, np.abs(want).max())


def test_predict_scores_are_sigmoid(tiny):
    import torch

    _, sm = _port_bundle(tiny, batch_sizes=(1,))
    x = _x(5, 1)
    logits = sm.predict(x)
    np.testing.assert_allclose(sm.predict_scores(x).numpy(), torch.sigmoid(logits).numpy(),
                               rtol=1e-6)


def test_http_server_roundtrip(tiny):
    from aum_tpu_torch.serving import make_http_server

    _, sm = _port_bundle(tiny, batch_sizes=(2,), labels=LABELS)
    srv = make_http_server(sm, "127.0.0.1", 0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"ok": True, "batch_sizes": [2], "include_frontend": False,
                          "audio_length": 64, "melbins": 32, "n_labels": 10}
        x = _x(6, 2)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict",
            data=json.dumps({"instances": x.tolist(), "topk": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        want = sm.predict_scores(x).numpy()
        np.testing.assert_allclose(np.asarray(out["scores"]), want, rtol=1e-5, atol=1e-6)
        top = out["topk"][0]
        assert len(top) == 3 and top[0]["label"] == LABELS[int(np.argmax(want[0]))]
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=b"not json",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_http_server_answers_concurrent_requests_as_sequential_ones(tiny):
    """Four threads POST to the server at once, three requests each of 1 to
    5 rows (padded to the bundle's sizes 2 and 4, or chunked): every answer
    equals a sequential ``predict_scores`` of the same rows."""
    from aum_tpu_torch.serving import make_http_server

    _, sm = _port_bundle(tiny, batch_sizes=(2, 4), labels=LABELS)
    srv = make_http_server(sm, "127.0.0.1", 0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    requests = {(t, i): _x(100 + 3 * t + i, 1 + (t + 2 * i) % 5) for t in range(4)
                for i in range(3)}
    answers, errors = {}, []

    def client(t):
        try:
            for i in range(3):
                body = json.dumps({"instances": requests[t, i].tolist()}).encode()
                req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    answers[t, i] = np.asarray(json.loads(r.read())["scores"], np.float32)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    clients = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not errors and len(answers) == 12
    for key, x in requests.items():
        np.testing.assert_array_equal(answers[key], sm.predict_scores(x).numpy(), err_msg=key)


def test_ast_bundle_round_trip_quantizes_nothing():
    import torch

    from aum_tpu_torch.models.ast import ASTConfig, ASTModel
    from aum_tpu_torch.serving import export_bundle, load_bundle

    model = ASTModel(ASTConfig(label_dim=4, input_fdim=32, input_tdim=64, depth=1, embed_dim=64,
                               num_heads=4), device="cpu", seed=1)
    x = _x(8, 2)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    for quant in (None, "int8"):
        blob = export_bundle(model, audio_length=64, melbins=32, batch_sizes=(2,),
                             weight_quant=quant)
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            assert not any("/int8" in n for n in np.load(io.BytesIO(zf.read("params.npz"))).files)
        np.testing.assert_array_equal(load_bundle(blob, device="cpu").predict(x).numpy(), want)


def test_serving_main_exports_a_pth_and_serve_rejects_parallel(tmp_path, capsys):
    import torch

    from aum_tpu_torch.configs import RECIPES
    from aum_tpu_torch.convert import save_reference_checkpoint
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.run import apply_overrides
    from aum_tpu_torch.serving import load_bundle, main

    sets = ["depth=2", "model_type=tiny", "n_class=4", "dtype=float32"]
    cfg = apply_overrides(RECIPES["speechcommands/aum-base_scratch"], sets)
    donor = AudioMamba(cfg.model_config(), device="cpu", seed=9)
    save_reference_checkpoint(donor, str(tmp_path / "x.pth"))
    out = str(tmp_path / "b.zip")
    argv = ["export", "--recipe", "speechcommands/aum-base_scratch", "--device", "cpu",
            "--ckpt", str(tmp_path / "x.pth"), "--out", out, "--batch-sizes", "2",
            "--weight-quant", "int8"] + [a for s in sets for a in ("--set", s)]
    main(argv)
    assert "wrote" in capsys.readouterr().out
    sm = load_bundle(out, device="cpu")
    assert sm.manifest["recipe"] == "speechcommands/aum-base_scratch"
    assert sm.manifest["weight_quant"] == "int8" and sm.input_shape == (128, 128)
    x = np.random.default_rng(0).standard_normal((2, 128, 128)).astype(np.float32)
    with torch.no_grad():
        want = donor(torch.from_numpy(x)).numpy()
    got = sm.predict(x).numpy()
    assert np.max(np.abs(got - want)) < 0.35 * max(1.0, np.abs(want).max())
    # A tensor-parallel export needs a model axis of 2: one process has no such mesh.
    with pytest.raises(ValueError, match="does not cover the world of 1"):
        main(argv[:-2] + ["--n-model", "2"])


@pytest.mark.parametrize("kw", [{"mesh": True}, {"model_axis": "model"}],
                         ids=["mesh", "model_axis"])
def test_multi_device_export_names_item_8(tiny, kw):
    """Multi-device export is ported (``tests/test_torch_parallel.py`` serves
    on two ranks). In one process: the one-rank mesh is recorded; a mesh of
    2 model ranks cannot be built (the mesh's ValueError, as JAX's
    ``make_mesh``); ``model_axis`` without a mesh axis larger than 1 is no
    tensor parallelism, as in JAX, so int8 is allowed with it."""
    from aum_tpu_torch.parallel import make_mesh
    from aum_tpu_torch.serving import export_bundle, load_bundle

    if "mesh" in kw:
        kw = {"mesh": make_mesh()}
        with pytest.raises(ValueError, match="does not cover the world of 1"):
            make_mesh(n_model=2)
    blob = export_bundle(tiny[1], audio_length=64, melbins=32, weight_quant="int8", **kw)
    m = load_bundle(blob, device="cpu").manifest
    assert m["n_devices"] == 1 and m["model_axis"] is None
    assert m["mesh_shape"] == ({"data": 1, "model": 1} if "mesh" in kw else None)
