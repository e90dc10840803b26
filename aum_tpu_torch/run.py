"""Experiment entry point: train and validate a recipe from WAV files.

Counterpart of ``aum_tpu/run.py``. Usage:

    python -m aum_tpu_torch.run --recipe as20k/aum-base_scratch \\
        --data-train train.json --data-val val.json [--data-eval eval.json] \\
        --label-csv labels.csv --exp-dir ./exp/as20k [--set key=value ...]
    python -m aum_tpu_torch.run --recipe epic_sounds/aum-base_scratch \\
        --epic-hdf5 audio.hdf5 --epic-annotations-train train.pkl \\
        --epic-annotations-val val.pkl --exp-dir ./exp/epic

It builds the datasets and pipelines (``aum_tpu_torch.data``; EPIC-SOUNDS
from its annotation pickles and HDF5 audio store), the
AudioMamba model from the recipe (weights drawn from the recipe's seed),
Adam with the recipe's schedule, and runs ``train_loop`` with a validation
pass and checkpoints each epoch; or only evaluates: ``--run-type eval``
from the ``models/`` directory a train run wrote (``--ckpt``), ``eval_wa``
on the average of the epoch checkpoints in [``--wa-start``, ``--wa-end``],
``eval_ensemble`` on their cumulative prediction ensemble. SpeechCommands
keeps the reference's post-train protocol: the best checkpoint is evaluated
on the validation and the test split; EPIC-SOUNDS evaluates its test split
(``--epic-annotations-test``, ``--run-type eval``) on the average of each
record's NUM_ENSEMBLE_VIEWS views. ``main(argv, pipelines=...)`` takes the
(train, val, eval) pipelines from the caller instead of building them from
the file arguments, e.g. over an in-memory EPIC dataset.

The model is the recipe's AudioMamba, or with ``--set model=ast`` the AST
baseline. A pretrained init comes from a reference checkpoint through the
porters (``aum_tpu_torch.convert``): ``imagenet_pretrain_path`` (an ImageNet
ViM, under ``imagenet_pretrain_modelkey``), ``aum_pretrain_path`` (an AuM,
its grid inferred at ``aum_pretrain_fstride``/``tstride``) or, for AST,
``ast_pretrain_path`` (its grid from the ``ast_pretrain_*`` geometry).
``--run-type eval --ckpt x.pth`` evaluates a reference AuM checkpoint.

It runs on the card unless ``--device`` names another device, and raises
without one. ``--set flexible_patch_sizes=8,12,16`` trains each step at a
patch size drawn from those (``train_loop``), and validates at the recipe's.

The parallel modes, as in JAX: one process per rank, e.g. ``torchrun
--nproc-per-node 4 -m aum_tpu_torch.run ... --n-model 2 --n-seq 2``.
``--multihost`` ("auto" by default) starts ``torch.distributed`` from
torchrun's environment or ``--coordinator-address`` (with
``--num-processes`` and ``--process-id``); the mesh is data x pipe x seq x
model with n_data = world / (n_model · n_seq · n_pipe): ``--n-model``
shards the mixers' d_inner (tensor parallelism), ``--n-seq`` splits each
scan's length (sequence parallelism), ``--n-pipe`` pipelines the block
stack over ``--pipe-microbatches`` (GPipe); seq and pipe cannot be
combined. NCCL runs with a card per rank, gloo on the CPU; ranks that
share a card name ``--dist-backend gloo``. Each rank reads its 'data'
slice of every split; only rank 0 writes files and prints the results.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="aum_tpu_torch experiment runner")
    p.add_argument("--recipe", required=True,
                   help="recipe key from aum_tpu_torch.configs.RECIPES")
    p.add_argument("--data-train")
    p.add_argument("--data-val")
    p.add_argument("--data-eval")
    p.add_argument("--label-csv")
    p.add_argument("--exp-dir", required=True)
    p.add_argument("--run-type", default="train",
                   choices=["train", "eval", "eval_wa", "eval_ensemble"])
    p.add_argument("--device", help="torch device (default: the CUDA card; "
                                    "raises without one)")
    p.add_argument("--profile-dir",
                   help="write a torch.profiler trace of train steps 3-8 of epoch 1 here")
    p.add_argument("--wa-start", type=int,
                   help="eval_wa: first epoch to average (default: the earliest)")
    p.add_argument("--wa-end", type=int,
                   help="eval_wa: last epoch to average (default: the latest)")
    p.add_argument("--ckpt", help="checkpoint directory: eval reads its best, "
                                  "eval_wa/eval_ensemble its epochs, train resumes; "
                                  "or a reference AuM .pth for eval")
    p.add_argument("--n-seq", type=int, default=1,
                   help="sequence-parallel axis size: each mixer's scans split in length")
    p.add_argument("--n-pipe", type=int, default=1,
                   help="pipeline-parallel axis size: the block stack runs GPipe-style "
                        "over this many stages (not with --n-seq)")
    p.add_argument("--pipe-microbatches", type=int, default=4,
                   help="GPipe microbatches per step (at most; a divisor of the batch)")
    p.add_argument("--n-model", type=int, default=1,
                   help="model-axis size: the mixers' d_inner sharded (tensor parallelism)")
    p.add_argument("--multihost", default="auto", choices=["auto", "on", "off"],
                   help="start torch.distributed: 'auto' under torchrun or with "
                        "--coordinator-address, 'on' always, 'off' never")
    p.add_argument("--coordinator-address", help="host:port of rank 0 (without torchrun)")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--dist-backend", choices=["nccl", "gloo"],
                   help="default: nccl on the card, gloo on the CPU; ranks that share a "
                        "card need gloo")
    p.add_argument("--epic-yaml", help="EPIC config yaml (needs the yaml package)")
    p.add_argument("--epic-hdf5", help="EPIC-KITCHENS audio hdf5")
    p.add_argument("--epic-annotations-train")
    p.add_argument("--epic-annotations-val")
    p.add_argument("--epic-annotations-test",
                   help="test split: NUM_ENSEMBLE_VIEWS per record, view-averaged predictions")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--set", action="append", default=[],
                   help="override recipe fields, e.g. --set lr=1e-4")
    return p.parse_args(argv)


def apply_overrides(cfg, overrides):
    fields = {f.name: f.type for f in dataclasses.fields(cfg)}
    kv = {}
    for item in overrides:
        k, v = item.split("=", 1)
        k = k.replace("-", "_")
        if k not in fields:
            raise ValueError(f"unknown recipe field {k}")
        cur = getattr(cfg, k)
        if "Tuple" in str(fields[k]):
            kv[k] = tuple(int(s) for s in v.split(","))
        elif isinstance(cur, bool):
            kv[k] = v in ("1", "true", "True")
        elif cur is None:
            for cast in (int, float):
                try:
                    kv[k] = cast(v)
                    break
                except ValueError:
                    continue
            else:
                kv[k] = v
        else:
            kv[k] = type(cur)(v)
    return dataclasses.replace(cfg, **kv)


def setup_mesh(args, device):
    """Start ``torch.distributed`` as ``--multihost`` says and build the
    mesh: (mesh, this rank's device)."""
    from aum_tpu_torch.parallel import make_mesh, maybe_initialize_distributed
    from aum_tpu_torch.parallel.multihost import rank_device

    if args.n_seq > 1 and args.n_pipe > 1:
        raise ValueError("--n-seq and --n-pipe cannot be combined")
    maybe_initialize_distributed(args.multihost, args.coordinator_address, args.num_processes,
                                 args.process_id, backend=args.dist_backend, device=device)
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return make_mesh(n_model=args.n_model, n_seq=args.n_seq, n_pipe=args.n_pipe), device


def build_pipelines(cfg, args, device, mesh=None):
    from aum_tpu_torch.data import AudioJsonDataset, BatchPipeline, balanced_sample_weights

    if cfg.dataset == "epic_sounds":
        return _build_epic_pipelines(cfg, args, device, mesh)
    if not args.label_csv:
        raise ValueError("--label-csv is required for this dataset")
    train_pipe = val_pipe = eval_pipe = None
    kw = dict(seed=cfg.seed, num_workers=args.num_workers, device=device, **_data_slice(mesh))
    if args.data_train:
        ds = AudioJsonDataset(args.data_train, cfg.audio_conf(train=True), args.label_csv)
        weights = balanced_sample_weights(ds) if cfg.bal else None
        train_pipe = BatchPipeline(ds, cfg.batch_size, train=True, weights=weights, **kw)
    if args.data_val:
        ds = AudioJsonDataset(args.data_val, cfg.audio_conf(train=False), args.label_csv)
        val_pipe = BatchPipeline(ds, cfg.batch_size * 2, train=False, **kw)
    if args.data_eval:
        ds = AudioJsonDataset(args.data_eval, cfg.audio_conf(train=False), args.label_csv)
        eval_pipe = BatchPipeline(ds, cfg.batch_size * 2, train=False, **kw)
    return train_pipe, val_pipe, eval_pipe


def epic_audio_config(cfg, yaml_path: str | None = None):
    """The EPIC audio config of recipe ``cfg`` (classes, frames, mel bins,
    masks, normalization), over the yaml's AUDIO_DATA keys where one is given."""
    from aum_tpu_torch.data.epic import EpicAudioConfig

    kw = dict(num_classes=cfg.n_class, num_frames=cfg.audio_length,
              num_frequencies=cfg.melbins, t_mask=cfg.timem, f_mask=cfg.freqm,
              mean=cfg.dataset_mean, std=cfg.dataset_std)
    return (EpicAudioConfig.from_yaml(yaml_path, **kw) if yaml_path
            else EpicAudioConfig(**kw))


def _data_slice(mesh) -> dict:
    """The pipelines' share of the data for this rank's 'data' coordinate."""
    if mesh is None:
        return {}
    return {"n_data": mesh.size("data"), "data_rank": mesh.coord("data")}


def _build_epic_pipelines(cfg, args, device, mesh=None):
    from aum_tpu_torch.data.epic import EpicBatchPipeline, EpicSoundsDataset

    ecfg = epic_audio_config(cfg, args.epic_yaml)
    pipe_kw = dict(seed=cfg.seed, num_workers=args.num_workers, device=device,
                   **_data_slice(mesh))
    pipes = []
    for ann, split, train, bs in ((args.epic_annotations_train, "train", True, cfg.batch_size),
                                  (args.epic_annotations_val, "val", False, cfg.batch_size * 2),
                                  (args.epic_annotations_test, "test", False,
                                   cfg.batch_size * 2)):
        pipes.append(None if not ann else EpicBatchPipeline(
            EpicSoundsDataset.from_files(ann, args.epic_hdf5, ecfg, split=split), bs,
            train=train, **pipe_kw))
    return tuple(pipes)


def evaluate_views(eval_step, pipe, main_metric: str, mesh=None):
    """EPIC's test protocol: each record's NUM_ENSEMBLE_VIEWS sigmoid scores
    (and targets) averaged before scoring (on a mesh, gathered over 'data'
    first). Returns (metrics, scores, stats); the loss is not computed (nan)."""
    from aum_tpu_torch.data.pipeline import Prefetcher
    from aum_tpu_torch.parallel.multihost import to_host_global
    from aum_tpu_torch.train import average_ensemble_views, calculate_stats, d_prime, sigmoid_np

    outs, tgts, recs = [], [], []
    for batch in Prefetcher(pipe.batches()):
        outs.append(eval_step(batch["x"]).float())
        tgts.append(batch["y"].float())
        recs.append(torch.as_tensor(batch["record_index"], device=outs[-1].device))
    rec = to_host_global(torch.cat(recs), mesh)
    _, scores = average_ensemble_views(sigmoid_np(to_host_global(torch.cat(outs), mesh)), rec)
    _, targets = average_ensemble_views(to_host_global(torch.cat(tgts), mesh), rec)
    stats = calculate_stats(scores, targets, full_curves=True)
    auc = float(np.nanmean([st["auc"] for st in stats]))
    metrics = {"mAP": float(np.nanmean([st["AP"] for st in stats])), "AUC": auc,
               "acc": stats[0]["acc"], "d_prime": d_prime(auc) if 0 < auc < 1 else float("nan"),
               "loss": float("nan"), "main": None}
    metrics["main"] = metrics["acc" if main_metric == "acc" else "mAP"]
    return metrics, scores, stats


def ast_config(cfg):
    """The AST of recipe ``cfg``: deit_base (768 wide, 12 heads) for
    ``model_type=base``, else deit_small (384, 6); 12 layers unless
    ``depth`` is set."""
    from aum_tpu_torch.models.ast import ASTConfig

    base = cfg.model_type == "base"
    return ASTConfig(label_dim=cfg.n_class, fstride=cfg.fstride, tstride=cfg.tstride,
                     input_fdim=cfg.melbins, input_tdim=cfg.audio_length,
                     embed_dim=768 if base else 384, num_heads=12 if base else 6,
                     depth=cfg.depth if cfg.depth is not None else 12, dtype=cfg.dtype)


def build_model(cfg, device, mesh=None, args=None):
    """The recipe's model, weights drawn from the recipe's seed, then any
    pretrained init ported over them (keys the checkpoint lacks keep their
    init); on a ``mesh``, laid out on it after that whole init, with the
    sequence- and pipeline-parallel axes that ``args`` ask for."""
    from aum_tpu_torch.convert import (
        load_torch_checkpoint,
        merge_with_init,
        port_ast_pretrain_state_dict,
        port_aum_state_dict,
        port_vim_imagenet_state_dict,
    )
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.models.ast import ASTModel

    if cfg.model == "ast":
        if mesh is not None and mesh.world // mesh.size("data") > 1:
            raise ValueError("model=ast runs data-parallel only: --n-model, --n-seq and "
                             "--n-pipe shard AudioMamba's blocks")
        if cfg.aum_drop_path:
            # The reference AST never enables stochastic depth or dropout
            # (timm's rates default to 0): refuse rather than silently train
            # an unregularized model.
            raise ValueError(
                "--aum_drop_path has no effect on the AST model: the reference AST never "
                "enables stochastic depth/dropout (timm defaults 0). Unset it for model=ast.")
        acfg = ast_config(cfg)
        model = ASTModel(acfg, device=device, seed=cfg.seed)
        if cfg.ast_pretrain_path:
            pre_grid = dataclasses.replace(
                acfg, fstride=cfg.ast_pretrain_fstride, tstride=cfg.ast_pretrain_tstride,
                input_fdim=cfg.ast_pretrain_input_fdim,
                input_tdim=cfg.ast_pretrain_input_tdim).patch_grid
            ported = port_ast_pretrain_state_dict(load_torch_checkpoint(cfg.ast_pretrain_path),
                                                  acfg, pretrain_grid=pre_grid)
            model.load_state_dict(merge_with_init(ported, model.state_dict()))
        return model

    mcfg = cfg.model_config()
    axes = {}
    if args is not None:
        axes = {"seq_axis": "seq" if args.n_seq > 1 else None,
                "pipe_axis": "pipe" if args.n_pipe > 1 else None,
                "pipe_microbatches": args.pipe_microbatches}
    model = AudioMamba(mcfg, device=device, seed=cfg.seed, **axes)
    ported = None
    if cfg.imagenet_pretrain_path:
        sd = load_torch_checkpoint(cfg.imagenet_pretrain_path, cfg.imagenet_pretrain_modelkey)
        ported = port_vim_imagenet_state_dict(sd, mcfg)
    elif cfg.aum_pretrain_path:
        ported = port_aum_state_dict(load_torch_checkpoint(cfg.aum_pretrain_path), mcfg,
                                     pretrain_fstride=cfg.aum_pretrain_fstride,
                                     pretrain_tstride=cfg.aum_pretrain_tstride)
    if ported is not None:
        model.load_state_dict(merge_with_init(ported, model.state_dict()))
    if mesh is not None:
        from aum_tpu_torch.parallel import shard_params

        shard_params(model, mesh)
    return model


def load_checkpoint(model, cfg, ckpt: str) -> None:
    """Load ``ckpt`` into ``model``: a reference AuM ``.pth`` through the
    porter (keys it lacks keep the model's values), else the best state of
    a checkpoint directory that a train run wrote."""
    from aum_tpu_torch.convert import load_torch_checkpoint, merge_with_init, port_aum_state_dict
    from aum_tpu_torch.parallel import gather_state_dict, load_full_state_dict
    from aum_tpu_torch.train import Checkpointer

    if ckpt.endswith(".pth"):
        ported = port_aum_state_dict(load_torch_checkpoint(ckpt), cfg.model_config())
        load_full_state_dict(model, merge_with_init(ported, gather_state_dict(model)))
    else:
        load_full_state_dict(model, Checkpointer(ckpt).model_state("best"))


def _write_eval_artifacts(exp_dir, metrics, scores, stats) -> None:
    """predictions_eval.csv, result_eval.csv ([main, mAUC, the mean of each
    class's middle PR precision and recall, d', loss]) and
    stats_eval.pickle (the per-class stats)."""
    np.savetxt(os.path.join(exp_dir, "predictions_eval.csv"), scores, delimiter=",")
    mid_p = float(np.mean([st["precisions"][len(st["precisions"]) // 2] for st in stats]))
    mid_r = float(np.mean([st["recalls"][len(st["recalls"]) // 2] for st in stats]))
    print(f"Avg Precision: {mid_p:.6f}\nAvg Recall: {mid_r:.6f}\n"
          f"d_prime: {metrics['d_prime']:.6f}")
    result = [metrics["main"], metrics["AUC"], mid_p, mid_r, metrics["d_prime"],
              metrics["loss"]]
    np.savetxt(os.path.join(exp_dir, "result_eval.csv"), np.asarray(result, dtype=np.float64),
               delimiter=",")
    with open(os.path.join(exp_dir, "stats_eval.pickle"), "wb") as f:
        pickle.dump(stats, f)


def main(argv=None, pipelines=None):
    from aum_tpu_torch.configs import RECIPES
    from aum_tpu_torch.train import (
        AugmentConfig,
        Checkpointer,
        average_params,
        init_train_state,
        loop,
        make_optimizer,
    )
    from aum_tpu_torch.parallel import load_full_state_dict
    from aum_tpu_torch.utils import resolve_device

    args = parse_args(argv)
    cfg = apply_overrides(RECIPES[args.recipe], args.set)
    mesh, device = setup_mesh(args, resolve_device(args.device))
    writer = mesh.rank == 0
    if writer:
        os.makedirs(args.exp_dir, exist_ok=True)
        with open(os.path.join(args.exp_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2)

    train_pipe, val_pipe, eval_pipe = pipelines or build_pipelines(cfg, args, device, mesh)
    model = build_model(cfg, device, mesh, args)
    # The steps, the eval and the loop are read from ``train.loop`` at call
    # time, where ``train_loop`` reads them too: wrapping that module's
    # names instruments every run type (chip_smoke.py's recipe probes).
    eval_step = loop.make_eval_step(model)
    hp = cfg.train_hp()

    if args.run_type in ("eval_wa", "eval_ensemble"):
        if not args.ckpt:
            raise ValueError("--ckpt (a checkpoint directory) is required")
        pipe = eval_pipe or val_pipe
        if pipe is None:
            raise ValueError("need --data-eval or --data-val")
        ckptr = Checkpointer(args.ckpt)
        epochs = ckptr.available_epochs()
        if not epochs:
            raise FileNotFoundError(f"no epoch checkpoints under {args.ckpt}")
        if args.run_type == "eval_wa":
            lo = args.wa_start if args.wa_start is not None else epochs[0]
            hi = args.wa_end if args.wa_end is not None else epochs[-1]
            epochs = [e for e in epochs if lo <= e <= hi]
            if not epochs:
                raise FileNotFoundError(f"no epoch checkpoints in [{lo}, {hi}]")
        state_dicts = [ckptr.model_state(f"epoch_{e}") for e in epochs]
        if args.run_type == "eval_wa":
            load_full_state_dict(model, average_params(state_dicts))
            metrics, _, _ = loop.evaluate(eval_step, pipe.batches(), cfg.loss, cfg.metrics,
                                          nan2num=cfg.nan2num, mesh=mesh)
            if writer:
                print(json.dumps({"n_models": len(state_dicts), **metrics}, default=float))
            return metrics
        results = loop.evaluate_ensemble(eval_step, model, state_dicts, pipe.batches,
                                         cfg.loss, cfg.metrics, nan2num=cfg.nan2num)
        for r in results if writer else ():
            print(json.dumps(r, default=float))
        return results

    if args.run_type == "eval":
        pipe = eval_pipe or val_pipe
        if pipe is None:
            raise ValueError("need --data-eval or --data-val")
        if args.ckpt:
            load_checkpoint(model, cfg, args.ckpt)
        if cfg.dataset == "epic_sounds" and eval_pipe is not None:
            metrics, scores, stats = evaluate_views(eval_step, eval_pipe, cfg.metrics, mesh)
        else:
            metrics, scores, _, stats = loop.evaluate(
                eval_step, pipe.batches(), cfg.loss, cfg.metrics, nan2num=cfg.nan2num,
                return_stats=True, full_curves=True, mesh=mesh)
        if writer:
            print(json.dumps(metrics, default=float))
            _write_eval_artifacts(args.exp_dir, metrics, scores, stats)
        return metrics

    if train_pipe is None or val_pipe is None:
        raise ValueError("training needs --data-train and --data-val")
    spe = max(train_pipe.steps_per_epoch(), 1)
    state = init_train_state(model, make_optimizer(model.parameters(), hp))
    start_epoch = 1
    if args.ckpt:  # resume from the newest epoch checkpoint (or best)
        rckptr = Checkpointer(args.ckpt, mesh)
        epochs = rckptr.available_epochs()
        state = rckptr.restore(f"epoch_{epochs[-1]}" if epochs else "best", state)
        start_epoch = epochs[-1] + 1 if epochs else 1
    ckptr = Checkpointer(os.path.join(args.exp_dir, "models"), mesh)
    state, history, best = loop.train_loop(
        state, hp, spe,
        train_batches=train_pipe.batches,
        eval_batches=val_pipe.batches,
        n_epochs=cfg.n_epochs, loss_type=cfg.loss, main_metric=cfg.metrics,
        augment=AugmentConfig(),  # the pipeline augments, on the device
        nan2num=cfg.nan2num, continue_inf=cfg.continue_inf,
        exp_dir=args.exp_dir if writer else None, checkpointer=ckptr,
        accum_steps=cfg.accum_steps, profile_dir=args.profile_dir if writer else None,
        print_fn=print if writer else (lambda *a, **k: None),
        flexible_patch_sizes=cfg.flexible_patch_sizes, start_epoch=start_epoch,
        generator=torch.Generator().manual_seed(cfg.seed + 2), mesh=mesh)
    if writer:
        print(f"best epoch {best['epoch']}: {cfg.metrics}={best['main']:.4f}")

    # SpeechCommands: the best checkpoint on the validation and test splits.
    if cfg.dataset == "speechcommands" and eval_pipe is not None:
        load_full_state_dict(model, ckptr.model_state("best"))
        for split, pipe in [("valid", val_pipe), ("eval", eval_pipe)]:
            m, _, _ = loop.evaluate(eval_step, pipe.batches(), cfg.loss, cfg.metrics,
                                    nan2num=cfg.nan2num, mesh=mesh)
            if writer:
                print(f"---------------evaluate on the {split} set---------------\n"
                      f"Accuracy: {m['acc']:.6f}\nAUC: {m['AUC']:.6f}")
    return history


if __name__ == "__main__":
    main()
