"""Serving: the served forward, bundles, int8 weights and an HTTP front.

Counterpart of ``aum_tpu/serving.py``.

- ``forward_fn``: x -> logits. With the frontend x is a (B, S) waveform and
  the forward follows the reference data loader: per-clip mean subtraction,
  the Kaldi fbank, zero-pad or crop to ``audio_length`` frames, then
  ``(x - mean) / (2 * std)``; without it x is a (B, T, melbins) log-mel.
- ``export_bundle`` / ``save_bundle`` write a bundle, one zip file:

    manifest.json  the JAX bundle's fields (input layout, norm stats,
                   labels, batch sizes, frontend flag, weight_quant, ...),
                   ``format_version``, and ``model``: its kind ("aum" or
                   "ast") and config, from which ``load_bundle`` rebuilds it
    params.npz     the state dict by its keys; an int8 weight as
                   ``<key>/int8`` and ``<key>/scale``

  There are no graph files: the forward is rebuilt at load. ``torch.export``
  cannot trace the kernels' ctypes calls (``ops/_build.py``); registering
  them as custom ops would still need this package at load time, so it would
  buy no independence from the model code, and it would add a tracing layer
  over every kernel wrapper.
- ``quantize_weights_int8`` / ``dequantize_params``: weight-only int8 of
  the AuM matmul weights (the mixers' in_proj, x_proj, dt_proj and out_proj,
  and the head), one scale per output channel, i.e. per row of an (out, in)
  weight: the JAX package's values and scales. The served forward
  dequantizes them at every call, as the JAX bundle's graph does. An AST
  bundle quantizes nothing, as in the JAX package.
- ``ServingModel`` (from ``load_bundle``): ``predict`` pads a request to the
  smallest exported batch size that fits, runs an oversized one in chunks of
  the largest, and returns exactly the requested rows; the shapes stay
  fixed, as in the JAX bundle. It runs under ``torch.inference_mode()`` on
  the card unless ``load_bundle`` is given another device.
- ``make_http_server``: GET /healthz, POST /predict (stdlib only).
- ``main``: ``python -m aum_tpu_torch.serving export ...`` and ``... serve
  ...``, the counterparts of ``scripts/export_serving.py`` and
  ``scripts/serve_http.py``.

Multi-device serving, one process per rank (``parallel/``): ``export_bundle(
mesh=, model_axis=)`` records ``n_devices``, ``mesh_shape`` and
the tensor-parallel ``model_axis`` in the manifest, as the JAX bundle does
(the params stay in the one-card layout; a model already laid out on a mesh
is gathered first, a collective of its ranks); every exported batch size
must divide over the data axis, and int8 together with ``model_axis``
raises, as in JAX. ``load_bundle`` under a process group of ``n_devices``
ranks re-applies the layout: the mixers' d_inner sharded over 'model', the
weights replicated over 'data'. ``predict`` is then a collective of every
rank: rank 0's request is broadcast, padded to an exported size, split over
'data', run, and the logits gathered back to every rank. ``serve`` runs the
HTTP server on rank 0 while the other ranks follow its broadcasts
(``ServingModel.follow``) until it stops (``stop_followers``).
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import re
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from aum_tpu_torch.audio import FbankConfig, fbank, normalize
from aum_tpu_torch.utils import resolve_device

__all__ = ["ServingModel", "dequantize_params", "export_bundle", "forward_fn", "frontend_fn",
           "load_bundle", "make_http_server", "quantize_weights_int8", "save_bundle"]

FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_PARAMS = "params.npz"
# The JAX package's int8 targets by state-dict key: the AuM matmul weights
# (where the parameter bytes are). The patch embedding, A_log, D, the
# depthwise conv, biases, norms and the cls and pos embeddings stay float.
_INT8_KEY = re.compile(
    r"head\.weight|layers\.\d+\.mixer\.(in_proj|x_proj|x_proj_b|dt_proj|dt_proj_b|out_proj)"
    r"\.weight")
_QUANT_KEYS = ("int8", "scale")


def frontend_fn(*, audio_length: int, melbins: int, mean: float, std: float,
                sample_rate: int) -> Callable:
    """(B, S) waveform -> (B, audio_length, melbins) normalized fp32 log-mel."""
    fcfg = FbankConfig(sample_frequency=sample_rate, num_mel_bins=melbins)

    def frontend(wav: torch.Tensor) -> torch.Tensor:
        wav = wav - wav.mean(dim=-1, keepdim=True)
        fb = fbank(wav, fcfg)  # (B, T, M)
        t = fb.shape[1]
        fb = F.pad(fb, (0, 0, 0, audio_length - t)) if t < audio_length else fb[:, :audio_length]
        return normalize(fb, mean, std)

    return frontend


def forward_fn(model: Callable, *, include_frontend: bool, audio_length: int,
               melbins: int, mean: float, std: float, sample_rate: int) -> Callable:
    """x -> logits: x is a (B, S) waveform with the frontend, else a (B, T,
    melbins) log-mel. The caller picks the autograd mode (eval callers wrap
    it in ``train.make_eval_step``)."""
    if not include_frontend:
        return model
    frontend = frontend_fn(audio_length=audio_length, melbins=melbins, mean=mean, std=std,
                           sample_rate=sample_rate)
    return lambda wav: model(frontend(wav))


def _is_quant_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == set(_QUANT_KEYS)


def quantize_weights_int8(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Each targeted weight w -> {"int8": round(w / s), "scale": s}, with
    s = max|w| / 127 per output channel (a row of w; 1 where a row is all
    zero); every other entry as it is."""
    out: Dict[str, Any] = {}
    for k, w in state_dict.items():
        if not _INT8_KEY.fullmatch(k):  # every match is an (out, in) weight
            out[k] = w
            continue
        w = w.detach().float()
        s = w.abs().amax(dim=1, keepdim=True) / 127.0
        s = torch.where(s == 0.0, torch.ones_like(s), s)
        out[k] = {"int8": torch.clamp(torch.round(w / s), -127, 127).to(torch.int8),
                  "scale": s}
    return out


def dequantize_params(qparams: Dict[str, Any], dtype=torch.float32) -> Dict[str, Any]:
    """Invert ``quantize_weights_int8``: int8 * scale in ``dtype``."""
    return {k: v["int8"].to(dtype) * v["scale"].to(dtype) if _is_quant_leaf(v) else v
            for k, v in qparams.items()}


def _flatten(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in params.items():
        for sub, t in (v.items() if _is_quant_leaf(v) else [(None, v)]):
            out[k if sub is None else f"{k}/{sub}"] = t.detach().cpu().numpy()
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        name, _, sub = key.rpartition("/")
        if sub in _QUANT_KEYS and name:
            out.setdefault(name, {})[sub] = torch.from_numpy(v)
        else:
            out[key] = torch.from_numpy(v)
    return out


def _model_kind(model) -> str:
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.models.ast import ASTModel

    if isinstance(model, AudioMamba):
        return "aum"
    if isinstance(model, ASTModel):
        return "ast"
    raise TypeError(f"cannot export a {type(model).__name__}: AudioMamba or ASTModel only")


def _build_model(spec: Dict[str, Any], device: torch.device) -> torch.nn.Module:
    """The manifest's model, with init weights, on ``device`` (whole)."""
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.models.ast import ASTConfig, ASTModel

    model_cls, cfg_cls = {"aum": (AudioMamba, AudioMambaConfig),
                          "ast": (ASTModel, ASTConfig)}[spec["kind"]]
    # JSON keeps tuples as lists.
    cfg = cfg_cls(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in spec["config"].items()})
    return model_cls(cfg, device=device)


def export_bundle(
    model,
    params: Optional[Dict[str, torch.Tensor]] = None,
    *,
    audio_length: int,
    melbins: int,
    batch_sizes: Sequence[int] = (1, 8),
    mean: float = 0.0,
    std: float = 0.5,
    labels: Optional[Sequence[str]] = None,
    include_frontend: bool = False,
    sample_rate: int = 16000,
    wav_samples: Optional[int] = None,
    mesh=None,
    model_axis: Optional[str] = None,
    weight_quant: Optional[str] = None,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> bytes:
    """``model`` (an AudioMamba or ASTModel) with ``params`` (its state dict;
    default: the model's own) as a serving bundle (zip bytes). Served inputs
    are (B, audio_length, melbins) log-mels, or with ``include_frontend``
    (B, wav_samples) waveforms at ``sample_rate``. ``weight_quant="int8"``
    stores the matmul weights as int8 (``quantize_weights_int8``).

    ``mesh`` (``parallel.make_mesh``'s) serves the bundle over that many
    ranks: the batch split over its 'data' axis and, with ``model_axis``
    ("model", the mesh's tensor-parallel axis), the mixers' d_inner over
    it when that axis is larger than 1; the manifest records the
    layout and ``load_bundle`` re-applies it. A model laid out on a mesh is
    gathered (call it on every rank)."""
    if include_frontend and wav_samples is None:
        raise ValueError("include_frontend=True requires wav_samples")
    if weight_quant not in (None, "int8"):
        raise ValueError(f"unknown weight_quant {weight_quant!r}")
    if model_axis not in (None, "model"):
        raise ValueError(f"model_axis must be None or 'model' (the mesh's tensor-parallel "
                         f"axis), not {model_axis!r}")
    tp = bool(mesh is not None and model_axis is not None and mesh.size(model_axis) > 1)
    if weight_quant == "int8" and tp:
        raise ValueError("weight_quant is not supported together with model_axis (TP): the "
                         "TP layout is defined on the float state dict")
    if mesh is not None:
        for bsz in batch_sizes:
            if int(bsz) % mesh.size("data"):
                raise ValueError(f"batch size {bsz} not divisible by mesh axis "
                                 f"'data' = {mesh.size('data')}")
    kind = _model_kind(model)
    if getattr(model, "mesh", None) is not None:
        from aum_tpu_torch.parallel import gather_state_dict

        whole = gather_state_dict(model)
    else:
        whole = model.state_dict()
    want = {k: tuple(v.shape) for k, v in whole.items()}
    params = whole if params is None else params
    got = {k: tuple(v.shape) for k, v in params.items()}
    if got != want:
        raise ValueError("params do not fit the model: " + (
            f"keys {sorted(set(got) ^ set(want))}" if set(got) != set(want)
            else f"shapes of {sorted(k for k in got if got[k] != want[k])}"))
    if weight_quant == "int8":
        params = quantize_weights_int8(params)
    manifest = {
        "format_version": FORMAT_VERSION,
        "batch_sizes": sorted(set(int(b) for b in batch_sizes)),
        "audio_length": audio_length,
        "melbins": melbins,
        "mean": mean,
        "std": std,
        "sample_rate": sample_rate,
        "include_frontend": include_frontend,
        "wav_samples": wav_samples,
        "platforms": None,  # no lowered graph: the forward is rebuilt at load
        "labels": list(labels) if labels is not None else None,
        "n_devices": mesh.world if mesh is not None else 1,
        "data_axis": "data" if mesh is not None else None,
        # The mesh's axes in order -> size, and the TP axis, so that
        # load_bundle rebuilds the mesh and re-applies the layout.
        "mesh_shape": ({a: mesh.size(a) for a in mesh.axis_names}
                       if mesh is not None else None),
        "model_axis": model_axis if tp else None,
        "weight_quant": weight_quant,
        "model": {"kind": kind, "config": dataclasses.asdict(model.config)},
    }
    if extra_meta:
        manifest.update(extra_meta)
    pbuf = io.BytesIO()
    np.savez(pbuf, **_flatten(params))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr(_MANIFEST, json.dumps(manifest, indent=1), zipfile.ZIP_DEFLATED)
        # Stored: float weights do not compress, and deflating them costs
        # seconds per 100 MB.
        zf.writestr(_PARAMS, pbuf.getvalue(), zipfile.ZIP_STORED)
    return buf.getvalue()


def save_bundle(path: str, *args, **kwargs) -> None:
    """``export_bundle`` written to ``path`` (on a mesh, by rank 0 alone)."""
    blob = export_bundle(*args, **kwargs)
    mesh = kwargs.get("mesh")
    if mesh is None or mesh.rank == 0:
        with open(path, "wb") as f:
            f.write(blob)


@dataclasses.dataclass
class ServingModel:
    """A loaded bundle: its manifest and its forward on ``device``.

    ``predict(x)`` pads the request batch up to the smallest exported size
    that fits (oversized requests run in chunks of the largest size) and
    returns the logits of exactly the requested rows, on ``device``. With a
    ``mesh`` (a multi-device bundle) it is a collective of every rank:
    rank 0's ``x`` is the request (the others may pass None), and every
    rank returns the logits.
    """

    manifest: Dict[str, Any]
    forward: Callable = dataclasses.field(repr=False)
    device: torch.device
    mesh: Any = None

    @property
    def labels(self) -> Optional[List[str]]:
        return self.manifest.get("labels")

    @property
    def batch_sizes(self) -> List[int]:
        return list(self.manifest["batch_sizes"])

    @property
    def input_shape(self) -> tuple:
        """One request row's shape: (wav_samples,) or (audio_length, melbins)."""
        m = self.manifest
        return ((m["wav_samples"],) if m["include_frontend"]
                else (m["audio_length"], m["melbins"]))

    def _collective(self) -> bool:
        return self.mesh is not None and self.mesh.distributed

    def _broadcast_request(self, x, op: int = 1):
        """Rank 0's (op, request) to every rank; op 0 stops the followers."""
        from aum_tpu_torch.parallel import collectives

        group = torch.distributed.group.WORLD
        head = torch.zeros(2, dtype=torch.int64, device=self.device)
        if self.mesh.rank == 0:
            head[0], head[1] = op, (0 if x is None else x.shape[0])
        collectives.broadcast(head, 0, group, tag="serve_request")
        op, b = int(head[0]), int(head[1])
        if op == 0:
            return None
        if self.mesh.rank != 0:
            x = torch.empty((b,) + self.input_shape, dtype=torch.float32, device=self.device)
        return collectives.broadcast(x.contiguous(), 0, group, tag="serve_request")

    def _run_split(self, x: torch.Tensor) -> torch.Tensor:
        """An exported-size batch split over 'data', run, gathered back."""
        from aum_tpu_torch.parallel import collectives

        n, r = self.mesh.size("data"), self.mesh.coord("data")
        part = x.shape[0] // n
        with torch.inference_mode():
            out = self.forward(x[r * part:(r + 1) * part])
        return collectives.all_gather(out, self.mesh.group("data"), tag="serve_gather")

    def predict(self, x) -> torch.Tensor:
        if self._collective():
            if self.mesh.rank == 0:
                x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
            x = self._broadcast_request(x)
            return self._predict_rows(x)
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        return self._predict_rows(x)

    def follow(self) -> None:
        """A rank other than 0 of a multi-device bundle: run every request
        rank 0 broadcasts, until it stops the followers."""
        while True:
            x = self._broadcast_request(None)
            if x is None:
                return
            self._predict_rows(x)

    def stop_followers(self) -> None:
        if self._collective() and self.mesh.rank == 0:
            self._broadcast_request(None, op=0)

    def _predict_rows(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:]) != self.input_shape:
            raise ValueError(f"a request row has shape {tuple(x.shape[1:])}; this bundle "
                             f"takes {self.input_shape}")
        b = x.shape[0]
        sizes = self.batch_sizes
        fit = [s for s in sizes if s >= b]
        if fit:
            pad = fit[0] - b
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            if self._collective():
                out = self._run_split(x)
            else:
                with torch.inference_mode():
                    out = self.forward(x)
            return out[:b] if pad else out
        big = sizes[-1]
        return torch.cat([self._predict_rows(x[i:i + big]) for i in range(0, b, big)])

    def predict_scores(self, x) -> torch.Tensor:
        """Sigmoid scores (the reference notebook's readout)."""
        return torch.sigmoid(self.predict(x).float())


def make_http_server(sm: ServingModel, host: str = "127.0.0.1", port: int = 8000):
    """A minimal stdlib HTTP front for a ServingModel.

    Endpoints:
      GET  /healthz  -> {"ok": true, "batch_sizes": [...], ...}
      POST /predict  -> body {"instances": [[...], ...]} (nested lists of
                        (B, T, M) features or (B, S) waveforms, per the
                        bundle's include_frontend flag); returns
                        {"scores": [[...], ...]} sigmoid scores, plus
                        "topk": [[{"label", "score"}, ...], ...] when the
                        request asks for it and the bundle has label names.

    Returns an ``http.server.ThreadingHTTPServer`` (call
    ``serve_forever()``, or run it from a thread; a lock serializes the
    predict calls).
    """
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": "not found"})
            m = sm.manifest
            self._reply(200, {
                "ok": True, "batch_sizes": m["batch_sizes"],
                "include_frontend": m["include_frontend"],
                "audio_length": m["audio_length"], "melbins": m["melbins"],
                "n_labels": len(sm.labels) if sm.labels else 0,
            })

        def do_POST(self):
            if self.path != "/predict":
                return self._reply(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                x = np.asarray(req["instances"], np.float32)
                topk = int(req.get("topk", 0))
                with lock:
                    scores = sm.predict_scores(x).cpu().numpy()
            except Exception as e:  # noqa: BLE001 — a bad request, answered to the client
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            out: Dict[str, Any] = {"scores": scores.tolist()}
            if topk and sm.labels:
                idx = np.argsort(-scores, axis=-1)[:, :topk]
                out["topk"] = [[{"label": sm.labels[int(i)], "score": float(s[int(i)])}
                                for i in row] for row, s in zip(idx, scores)]
            self._reply(200, out)

    return ThreadingHTTPServer((host, port), Handler)


def _bundle_mesh(manifest: Dict[str, Any]):
    """The mesh a multi-device bundle runs on, from its manifest: this
    process group must have ``n_devices`` ranks."""
    import torch.distributed as dist

    from aum_tpu_torch.parallel import make_mesh

    n = int(manifest.get("n_devices") or 1)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(f"bundle exported for {n} devices; this process group has {world} "
                           "rank(s)")
    shape = manifest.get("mesh_shape") or {"data": n}
    return make_mesh(n_data=int(shape.get("data", 1)), n_model=int(shape.get("model", 1)),
                     n_seq=int(shape.get("seq", 1)), n_pipe=int(shape.get("pipe", 1)))


def load_bundle(src, device: str | torch.device | None = None) -> ServingModel:
    """Load a bundle from a path or bytes and rebuild its forward on
    ``device`` (default: the CUDA card; raises without one). A
    multi-device bundle loads on every rank of a process group of its
    ``n_devices`` ranks, with its recorded layout."""
    device = resolve_device(device)
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        manifest = json.loads(zf.read(_MANIFEST))
        with np.load(io.BytesIO(zf.read(_PARAMS))) as npz:
            params = _unflatten(dict(npz))
    if manifest.get("format_version") != FORMAT_VERSION or "model" not in manifest:
        raise ValueError("not a bundle of this package: it reads format "
                         f"{FORMAT_VERSION} with a model spec (a JAX bundle holds StableHLO "
                         "graphs instead)")
    model = _build_model(manifest["model"], device)
    quant = {k: {s: t.to(device) for s, t in v.items()}
             for k, v in params.items() if _is_quant_leaf(v)}
    result = model.load_state_dict({k: v for k, v in params.items() if k not in quant},
                                   strict=False)
    if result.unexpected_keys or set(result.missing_keys) != set(quant):
        raise ValueError(f"the bundle's params do not fit its model: missing "
                         f"{sorted(set(result.missing_keys) - set(quant))}, unexpected "
                         f"{result.unexpected_keys}")
    for k in quant:  # the forward takes these from the int8 copies
        model.get_parameter(k).data = torch.empty(0, device=device)
    mesh = None
    if int(manifest.get("n_devices") or 1) > 1:
        mesh = _bundle_mesh(manifest)
        if manifest.get("model_axis"):
            from aum_tpu_torch.parallel import shard_params

            shard_params(model, mesh)

    def model_fn(x: torch.Tensor) -> torch.Tensor:
        if not quant:
            return model(x)
        return torch.func.functional_call(model, dequantize_params(quant), (x,))

    fwd = forward_fn(model_fn, include_frontend=manifest["include_frontend"],
                     audio_length=manifest["audio_length"], melbins=manifest["melbins"],
                     mean=manifest["mean"], std=manifest["std"],
                     sample_rate=manifest["sample_rate"])
    return ServingModel(manifest=manifest, forward=fwd, device=device, mesh=mesh)


def main(argv=None) -> None:
    """``export``: a recipe's model (from ``--ckpt``: a checkpoint
    directory's best state or a reference AuM ``.pth``; else its random
    init) as a bundle; ``serve``: a bundle over HTTP."""
    p = argparse.ArgumentParser(prog="python -m aum_tpu_torch.serving")
    sub = p.add_subparsers(dest="command", required=True)
    ex = sub.add_parser("export", help="write a serving bundle")
    ex.add_argument("--recipe", default="audioset/aum-base_scratch")
    ex.add_argument("--ckpt", help="checkpoint directory or reference .pth; omitted: a "
                                   "random init (a flow check only)")
    ex.add_argument("--label-csv")
    ex.add_argument("--out", required=True)
    ex.add_argument("--batch-sizes", default="1,8")
    ex.add_argument("--include-frontend", action="store_true",
                    help="serve waveforms of --clip-secs (fbank on the device)")
    ex.add_argument("--clip-secs", type=float, default=10.0)
    ex.add_argument("--sample-rate", type=int, default=16000)
    ex.add_argument("--weight-quant", choices=["int8"])
    ex.add_argument("--n-data", type=int, default=0,
                    help="multi-device bundle: data-axis size (0: one device)")
    ex.add_argument("--n-model", type=int, default=1,
                    help="tensor-parallel bundle: model-axis size")
    ex.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    help="default: nccl on the card, gloo on the CPU")
    ex.add_argument("--set", action="append", default=[])
    ex.add_argument("--device", help="torch device (default: the CUDA card)")
    sv = sub.add_parser("serve", help="serve a bundle over HTTP")
    sv.add_argument("--bundle", required=True)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--device", help="torch device (default: the CUDA card)")
    sv.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    help="default: nccl on the card, gloo on the CPU")
    args = p.parse_args(argv)

    from aum_tpu_torch.parallel import maybe_initialize_distributed
    from aum_tpu_torch.parallel.multihost import rank_device

    device = resolve_device(args.device)
    if maybe_initialize_distributed("auto", backend=args.dist_backend, device=device):
        device = rank_device(device)
    if args.command == "serve":
        sm = load_bundle(args.bundle, device)
        if sm.mesh is not None and sm.mesh.rank != 0:
            sm.follow()
            return
        print(f"serving {args.bundle} on {args.host}:{args.port} (batch sizes "
              f"{sm.batch_sizes}, frontend={'wav' if sm.manifest['include_frontend'] else 'fbank'})",
              flush=True)
        try:
            make_http_server(sm, args.host, args.port).serve_forever()
        finally:
            sm.stop_followers()
        return

    from aum_tpu_torch.configs import RECIPES
    from aum_tpu_torch.data.datasets import make_name_dict
    from aum_tpu_torch.run import apply_overrides, build_model, load_checkpoint

    mesh = None
    if args.n_data or args.n_model > 1:
        from aum_tpu_torch.parallel import make_mesh

        mesh = make_mesh(n_data=args.n_data or None, n_model=max(args.n_model, 1))
    cfg = apply_overrides(RECIPES[args.recipe], args.set)
    model = build_model(cfg, device)
    if args.ckpt:
        load_checkpoint(model, cfg, args.ckpt)
    else:
        print("# no --ckpt: exporting a RANDOM-INIT model (a flow check only)")
    labels = None
    if args.label_csv:
        names = make_name_dict(args.label_csv)
        labels = [names.get(i, str(i)) for i in range(cfg.n_class)]
    save_bundle(args.out, model, audio_length=cfg.audio_length, melbins=cfg.melbins,
                batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
                mean=cfg.dataset_mean, std=cfg.dataset_std, labels=labels,
                include_frontend=args.include_frontend, sample_rate=args.sample_rate,
                wav_samples=(int(args.clip_secs * args.sample_rate) if args.include_frontend
                             else None),
                mesh=mesh, model_axis="model" if args.n_model > 1 else None,
                weight_quant=args.weight_quant,
                extra_meta={"recipe": args.recipe, "variant": cfg.model_type,
                            "aum_type": cfg.aum_type})
    if mesh is None or mesh.rank == 0:
        print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
