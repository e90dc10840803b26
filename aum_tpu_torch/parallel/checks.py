"""Per-rank bodies of the parallel modes' checks, run by ``parallel/launch.py``.

Each function runs on every rank of a spawned process group (or, with no
group, in one process: the same code on a mesh of one rank, which is the
one-process reference a parallel run is held to) and returns plain data:
numpy arrays and numbers, the one-card-layout results on rank 0 only.
Each runs on the card unless its ``device`` names another device.

- ``train_leg``: an AudioMamba on a mesh (``layout``), its eval logits, the
  loss and grads of one forward and backward, then ``steps`` train steps
  (``make_train_step``), the updated parameters in the one-card layout, the
  kernels' launch counts, the collectives' bytes, peak memory and seconds.
- ``scan_leg``: ``ops/seq_parallel.py::seq_parallel_scan`` on a 'seq' group,
  outputs, final state and every grad.
- ``checkpoint_leg``: restore a one-card checkpoint into a parallel run,
  step, and save the gathered state again.
- ``serve_leg``: multi-device bundles (data- and tensor-parallel) exported,
  loaded and asked to predict.
- ``run_leg``: ``run.main`` on every rank.
- ``dryrun_leg``: the legs of ``entry.dryrun_multichip``.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from aum_tpu_torch.parallel import collectives
from aum_tpu_torch.parallel.mesh import gather_named, full_param_names, make_mesh
from aum_tpu_torch.utils import resolve_device


def launch_counters() -> dict:
    """Every kernel launch counter of the port: name -> (holder, attribute)."""
    from aum_tpu_torch.ops import causal_conv1d, selective_scan, selective_scan_bwd, \
        selective_scan_dual
    from aum_tpu_torch.ops.selective_scan import scan_combine_bwd_cuda, scan_combine_cuda

    dual = {"selective_scan_dual_fwd": "launches",
            "selective_scan_dual_fwd_save_states": "save_states_launches",
            "selective_scan_dual_direct_fwd": "direct_launches",
            "selective_scan_dual_direct_fwd_save_states": "direct_save_states_launches",
            "selective_scan_dual_fdt_fwd": "fdt_launches",
            "selective_scan_dual_stage_fwd": "stage_launches",
            "selective_scan_dual_stage_fwd_save_states": "stage_save_states_launches",
            "selective_scan_dual_fwd_sliced": "sliced_launches"}
    single = {"selective_scan_fwd": "launches",
              "selective_scan_fwd_save_states": "save_states_launches",
              "selective_scan_fwd_with_state": "with_state_launches",
              "selective_scan_fwd_sliced": "sliced_launches"}
    bwd = {"selective_scan_bwd": "launches",
           "selective_scan_bwd_sliced": "sliced_launches",
           "selective_scan_bwd_with_state": "with_state_launches",
           "selective_scan_bwd_fused": "fused_launches",
           "selective_scan_bwd_xminus": "xminus_launches",
           "selective_scan_bwd_bf16_partials": "bf16_partials_launches"}
    return {**{k: (selective_scan_dual, a) for k, a in dual.items()},
            **{k: (selective_scan, a) for k, a in single.items()},
            **{k: (selective_scan_bwd, a) for k, a in bwd.items()},
            "causal_conv1d_fwd": (causal_conv1d, "launches"),
            "causal_conv1d_fwd_general": (causal_conv1d, "general_launches"),
            "scan_combine_fwd": (scan_combine_cuda, "launches"),
            "scan_combine_bwd": (scan_combine_bwd_cuda, "launches")}


def reset_counts() -> None:
    for holder, attr in launch_counters().values():
        setattr(holder, attr, 0)
    collectives.reset_counts()


def read_counts() -> dict:
    return {"launches": {k: getattr(h, a) for k, (h, a) in launch_counters().items()},
            "bytes": dict(collectives.BYTES)}


def _np(t: torch.Tensor) -> np.ndarray:
    """A numpy copy (a CPU fp32 tensor's ``numpy()`` would share its memory)."""
    return t.detach().float().cpu().numpy().copy()


def _mesh(layout: dict):
    return make_mesh(n_data=layout.get("n_data"), n_model=layout.get("n_model", 1),
                     n_seq=layout.get("n_seq", 1), n_pipe=layout.get("n_pipe", 1))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_model(config: dict, seed: int, layout: dict, device: torch.device, mesh):
    """The AudioMamba of ``config`` from ``seed``, laid out on ``mesh``."""
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.parallel.mesh import shard_params

    cfg = AudioMambaConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in config.items()})
    model = AudioMamba(cfg, device=device, seed=seed,
                       seq_axis="seq" if layout.get("n_seq", 1) > 1 else None,
                       pipe_axis="pipe" if layout.get("n_pipe", 1) > 1 else None,
                       pipe_microbatches=layout.get("pipe_microbatches", 4))
    return shard_params(model, mesh)


def _rows(a: np.ndarray, mesh, device) -> torch.Tensor:
    n, r = mesh.size("data"), mesh.coord("data")
    b = a.shape[0] // n
    return torch.from_numpy(np.ascontiguousarray(a[r * b:(r + 1) * b])).to(device)


def train_leg(layout: dict, config: dict, seed: int, x: np.ndarray, y: np.ndarray,
              hp: dict | None = None, steps: int = 1, device: str | None = None,
              gen_seed: int = 1, drop_masks=None, logits: bool = True, grads: bool = True,
              params: bool = True, timed_steps: int = 0) -> dict:
    """See the module docstring. ``x``, ``y``: the global batch (every rank
    takes its 'data' rows). ``drop_masks`` feeds the model's drop-path
    masks (``AudioMamba.forward``'s) instead of its own draws; ``logits``,
    ``grads`` and ``params`` say what is returned. ``timed_steps`` more
    steps run after ``steps``, each timed (host clock to a synchronise)
    with its launches and bytes counted."""
    from aum_tpu_torch.train import (
        TrainHyperParams,
        init_train_state,
        loss_fn_of,
        make_optimizer,
        make_train_step,
    )
    from aum_tpu_torch.train.loop import average_grads

    device = resolve_device(device)
    mesh = _mesh(layout)
    model = build_model(config, seed, layout, device, mesh)
    if drop_masks is not None:
        model.forward = functools.partial(model.forward, drop_masks=drop_masks)
    xb, yb = _rows(x, mesh, device), _rows(y, mesh, device)
    names = full_param_names(model)
    out = {"rank": mesh.rank, "mesh": dict(mesh.shape)}
    reset_counts()
    if logits:
        with torch.inference_mode():
            out["logits"] = _np(collectives.all_gather(model(xb).float(), mesh.group("data")))
        out["eval_counts"] = read_counts()
    if grads:
        reset_counts()
        gen = torch.Generator().manual_seed(gen_seed)
        loss = loss_fn_of("BCE")(model(xb, train=True, generator=gen), yb)
        loss.backward()
        if mesh.distributed:
            average_grads(model.parameters(), mesh.group("data"), mesh.size("data"))
            loss = collectives.all_reduce(loss.detach().clone(), mesh.group("data")) \
                / mesh.size("data")
        out["loss"] = loss.item()
        out["grad_counts"] = read_counts()
        g = gather_named(model, {k: p.grad for k, p in model.named_parameters()}, mesh, names)
        out["grads"] = {k: _np(v) for k, v in g.items()} if mesh.rank == 0 else None
        model.zero_grad(set_to_none=True)
    hp = TrainHyperParams(**(hp or {}))
    state = init_train_state(model, make_optimizer(model.parameters(), hp))
    step = make_train_step(hp, 100, "BCE", generator=torch.Generator().manual_seed(gen_seed),
                           mesh=mesh)
    out["losses"] = []
    for _ in range(steps):
        state, loss = step(state, {"x": xb, "y": yb})
        out["losses"].append(float(loss))
    if steps and params:
        sd = gather_named(model, dict(model.named_parameters()), mesh, names)
        out["params"] = {k: _np(v) for k, v in sd.items()} if mesh.rank == 0 else None
    out["step_seconds"], out["step_counts"] = [], []
    for _ in range(timed_steps):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        state, loss = step(state, {"x": xb, "y": yb})
        _sync(device)
        out["step_seconds"].append(time.perf_counter() - t0)
        out["step_counts"].append(read_counts())
        out["losses"].append(float(loss))
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def scan_leg(cases: list, n_seq: int, device: str | None = None) -> list:
    """Each case: ``args`` (u, delta, A, B, C, D, z, delta_bias) global numpy
    arrays, ``reverse``, ``x0`` (B, D, N) or None, and the loss weights
    ``w`` (B, L, D) and ``wf`` (B, D, N). The scan's length is split over a
    'seq' group of ``n_seq`` ranks; the loss is sum(y·w) + sum(final·wf).
    Returns per case y, the final state and every grad (rank 0)."""
    from aum_tpu_torch.ops.seq_parallel import seq_parallel_scan

    device = resolve_device(device)
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    mesh = make_mesh(n_data=world // n_seq, n_seq=n_seq)
    group = mesh.group("seq")
    results = []
    for case in cases:
        leaves = [torch.tensor(a, dtype=torch.float32, device=device, requires_grad=True)
                  for a in case["args"]]
        x0 = (None if case.get("x0") is None else
              torch.tensor(case["x0"], dtype=torch.float32, device=device, requires_grad=True))
        u, delta, A, B, C, D, z, bias = leaves
        seg = [collectives.slice_segment(t, group, 1) for t in (u, delta, B, C, z)]
        rep = [collectives.copy_to_group(t, group) for t in (A, D, bias)]
        init = None if x0 is None else collectives.copy_to_group(x0, group)
        y, fin = seq_parallel_scan(seg[0], seg[1], rep[0], seg[2], seg[3], rep[1], seg[4],
                                   rep[2], True, reverse=case["reverse"], group=group,
                                   initial_state=init, return_final_state=True)
        y = collectives.gather_segments(y, group, 1)
        w = torch.tensor(case["w"], dtype=torch.float32, device=device)
        wf = torch.tensor(case["wf"], dtype=torch.float32, device=device)
        ((y * w).sum() + (fin * wf).sum()).backward()
        grads = [_np(t.grad) for t in leaves] + ([_np(x0.grad)] if x0 is not None else [])
        results.append({"y": _np(y), "final": _np(fin), "grads": grads})
    return results if mesh.rank == 0 else None


def checkpoint_leg(layout: dict, config: dict, seed: int, x: np.ndarray, y: np.ndarray,
                   hp: dict, restore_dir: str, save_dir: str, device: str | None = None) -> dict:
    """Restore ``restore_dir``'s ``epoch_1`` (one-card) into a run on
    ``layout``, take one train step, save ``epoch_2`` into ``save_dir``.
    Returns (rank 0) the restored and the stepped parameters, one-card
    layout, and the stepped Adam moments."""
    from aum_tpu_torch.train import Checkpointer, init_train_state, make_optimizer, \
        make_train_step
    from aum_tpu_torch.train.checkpoints import gather_optimizer_state
    from aum_tpu_torch.train.optim import TrainHyperParams

    device = resolve_device(device)
    mesh = _mesh(layout)
    model = build_model(config, seed + 1, layout, device, mesh)  # other weights: all restored
    hp = TrainHyperParams(**hp)
    state = init_train_state(model, make_optimizer(model.parameters(), hp))
    state = Checkpointer(restore_dir, mesh).restore("epoch_1", state)
    names = full_param_names(model)
    restored = gather_named(model, dict(model.named_parameters()), mesh, names)
    restored = {k: _np(v) for k, v in restored.items()}
    step = make_train_step(hp, 100, "BCE", generator=torch.Generator().manual_seed(1), mesh=mesh)
    state, loss = step(state, {"x": _rows(x, mesh, device), "y": _rows(y, mesh, device)})
    Checkpointer(save_dir, mesh).save_latest(state, 2, {"loss": float(loss)})
    after = gather_named(model, dict(model.named_parameters()), mesh, names)
    opt = gather_optimizer_state(model, state.optimizer, mesh, root_only=True)
    if mesh.rank != 0:
        return None
    return {"restored": restored, "after": {k: _np(v) for k, v in after.items()},
            "loss": float(loss), "step": state.step,
            "exp_avg": {names[i]: _np(s["exp_avg"]) for i, s in opt["state"].items()}}


def serve_leg(config: dict, seed: int, x: np.ndarray, batch_sizes=(2, 8),
              layouts=({"n_data": 2}, {"n_model": 2}), device: str | None = None) -> list:
    """For each layout: a bundle of the whole model exported on that mesh
    (``model_axis`` where the layout has one), loaded under the process
    group, ``predict(x)`` (rank 0's request). Returns (rank 0) per layout
    the manifest's layout fields and the logits."""
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.serving import export_bundle, load_bundle

    device = resolve_device(device)
    out = []
    for layout in layouts:
        mesh = _mesh(layout)
        cfg = AudioMambaConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in config.items()})
        model = AudioMamba(cfg, device=device, seed=seed)
        f, t = cfg.spectrogram_size
        blob = export_bundle(model, audio_length=t, melbins=f, batch_sizes=batch_sizes,
                             mesh=mesh, model_axis="model" if layout.get("n_model", 1) > 1
                             else None)
        sm = load_bundle(blob, device=device)
        reset_counts()
        logits = sm.predict(x if mesh.rank == 0 else None)
        m = sm.manifest
        out.append({"manifest": {k: m[k] for k in ("n_devices", "data_axis", "mesh_shape",
                                                    "model_axis")},
                    "logits": _np(logits), "counts": read_counts()})
    return out if torch.distributed.get_rank() == 0 else None


def suite_leg(legs: list) -> dict:
    """Several legs on one process group, in order: ``legs`` is a list of
    (name, function name in this module, kwargs). Returns name -> result,
    and each leg's seconds under "leg_seconds"."""
    out, seconds = {}, {}
    for name, fn, kwargs in legs:
        t0 = time.perf_counter()
        out[name] = globals()[fn](**kwargs)
        seconds[name] = time.perf_counter() - t0
    return {**out, "leg_seconds": seconds}


def run_leg(argv: list, checkpoint: str | None = None) -> dict:
    """``run.main(argv)`` on this rank, its kernel launches and collective
    bytes counted, and each checkpoint save's seconds and the device memory
    it allocated above what was held before it, per rank. With ``checkpoint`` (a file the run writes), the trained
    model's parameters are gathered into the one-card layout and rank 0
    loads the checkpoint into a one-process model on its device: whether
    the two are bit-equal. Rank 0's."""
    from aum_tpu_torch import run
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.parallel.mesh import gather_state_dict
    from aum_tpu_torch.train.checkpoints import Checkpointer

    built, saved, saves, save = [], run.build_model, [], Checkpointer._save

    def build_model(*args, **kwargs):
        built.append(saved(*args, **kwargs))
        return built[-1]

    def timed_save(self, name, state):
        device = next(state.model.parameters()).device
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            held = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        save(self, name, state)
        _sync(device)
        saves.append({"name": name, "seconds": time.perf_counter() - t0,
                      "extra_peak_bytes": torch.cuda.max_memory_allocated(device) - held
                      if cuda else None})

    run.build_model, Checkpointer._save = build_model, timed_save
    reset_counts()
    t0 = time.perf_counter()
    try:
        result = run.main(argv)
    finally:
        run.build_model, Checkpointer._save = saved, save
    out = {"result": result, "counts": read_counts(), "seconds": time.perf_counter() - t0}
    out["saves_per_rank"] = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out["saves_per_rank"], saves)
    if checkpoint is not None:
        gathered = gather_state_dict(built[0])
        if torch.distributed.get_rank() == 0:
            device = built[0].head.weight.device
            one = AudioMamba(built[0].config, device=device, seed=1)  # other weights: all loaded
            one.load_state_dict(torch.load(checkpoint, map_location=device,
                                           weights_only=True)["model"])
            restored = one.state_dict()
            out["checkpoint_keys"] = len(restored)
            out["checkpoint_equal"] = (set(restored) == set(gathered) and all(
                torch.equal(restored[k], gathered[k].to(device)) for k in restored))
    return out if torch.distributed.get_rank() == 0 else None


DRYRUN_CONFIG = dict(depth=4, embed_dim=192, spectrogram_size=(128, 128), num_classes=35)


def dryrun_leg(n: int, device: str | None = None) -> dict:
    """``entry.dryrun_multichip``'s legs on ``n`` ranks, JAX's conditions on
    n: one train step of AuM (depth 4, width 192, 128 x 128 log-mels, 35
    classes, SpecAugment) on a data x model mesh (model 2 where n is even);
    the sequence-parallel scan over all n ranks against the one-process
    oracle, with grads; for n a multiple of 8, the data x seq x model step
    and the data x pipe step (4 stages, 2 microbatches; with and without
    drop path), each of whose losses must equal the 2D step's."""
    from aum_tpu_torch.ops.scan_ref import selective_scan_ref
    from aum_tpu_torch.ops.seq_parallel import seq_parallel_scan
    from aum_tpu_torch.train import AugmentConfig, TrainHyperParams, init_train_state, \
        make_optimizer, make_train_step

    device = resolve_device(device)
    reset_counts()
    g = torch.Generator().manual_seed(1)
    n_model = 2 if n % 2 == 0 and n >= 2 else 1
    bsz = max(2 * (n // n_model), 2)
    x = torch.randn((bsz, 128, 128), generator=g).numpy()
    y = np.eye(35, dtype=np.float32)[torch.randint(0, 35, (bsz,), generator=g).numpy()]
    hp = TrainHyperParams(lr=1e-4, n_epochs=2)

    def step_loss(layout, cfg=DRYRUN_CONFIG):
        mesh = _mesh(layout)
        model = build_model(cfg, 0, layout, device, mesh)
        state = init_train_state(model, make_optimizer(model.parameters(), hp))
        step = make_train_step(hp, 10, "BCE", AugmentConfig(freqm=24, timem=24),
                               generator=torch.Generator().manual_seed(3),
                               aug_generator=torch.Generator(device=device).manual_seed(3),
                               mesh=mesh)
        before = state.step
        state, loss = step(state, {"x": _rows(x, mesh, device), "y": _rows(y, mesh, device)})
        loss = float(loss)
        if not np.isfinite(loss) or state.step != before + 1:
            raise RuntimeError(f"dryrun step on {layout}: loss {loss}, step {state.step}")
        return mesh, loss

    mesh, loss = step_loss({"n_data": n // n_model, "n_model": n_model})
    out = {"mesh": {a: mesh.size(a) for a in mesh.axis_names}, "loss": loss}

    # The sequence-parallel scan over all n ranks, against the oracle.
    sp = make_mesh(n_data=1, n_seq=n)
    gs = torch.Generator().manual_seed(4)
    d, nst, length = 16, 4, 16 * n
    args = [torch.randn((2, length, d), generator=gs), torch.randn((2, length, d), generator=gs)
            * 0.5, -torch.exp(torch.randn((d, nst), generator=gs) * 0.3),
            torch.randn((2, length, nst), generator=gs), torch.randn((2, length, nst), generator=gs),
            torch.randn((d,), generator=gs), torch.randn((2, length, d), generator=gs),
            torch.randn((d,), generator=gs) * 0.2]
    args = [a.to(device).requires_grad_() for a in args]
    group = sp.group("seq")
    seg = [collectives.slice_segment(args[i], group, 1) for i in (0, 1, 3, 4, 6)]
    rep = [collectives.copy_to_group(args[i], group) for i in (2, 5, 7)]
    got = collectives.gather_segments(
        seq_parallel_scan(seg[0], seg[1], rep[0], seg[2], seg[3], rep[1], seg[4], rep[2], True,
                          group=group), group, 1)
    want = selective_scan_ref(*[a.detach().cpu() for a in args], delta_softplus=True)
    torch.testing.assert_close(got.detach().cpu(), want, rtol=2e-5, atol=2e-5)
    torch.sin(got).sum().backward()
    if not all(torch.isfinite(a.grad).all() for a in args):
        raise RuntimeError("dryrun: non-finite seq-parallel scan grads")

    if n >= 8 and n % 8 == 0:
        _, out["loss3"] = step_loss({"n_data": n // 4, "n_model": 2, "n_seq": 2})
        np.testing.assert_allclose(out["loss3"], loss, rtol=1e-5)
        pp = {"n_data": n // 4, "n_pipe": 4, "pipe_microbatches": 2}
        _, out["loss_pp"] = step_loss(pp)
        np.testing.assert_allclose(out["loss_pp"], loss, rtol=1e-5)
        _, out["loss_pp_dp"] = step_loss(pp, {**DRYRUN_CONFIG, "drop_path_rate": 0.2})
    out.update(device=str(device), launches=read_counts()["launches"])
    return out if torch.distributed.get_rank() == 0 else None
