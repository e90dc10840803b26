"""The train and eval steps.

Counterpart of ``aum_tpu/train/loop.py`` (``make_train_step``,
``make_eval_step``, ``TrainState``, ``loss_fn_of``) on one device, without
the mesh. One step: the forward in train mode, the loss (BCE or soft-label
CE on fp32 logits), the backward, and the Adam update with the step's lr
from ``lr_at_step``. As in the JAX step:

- ``nan2num`` coerces a non-finite loss before the backward;
- ``accum_steps`` splits the batch into equal microbatches and averages
  their grads before one update: the full-batch mean-loss step;
- a non-finite loss skips the update: the params and the Adam moments and
  count stay as they were, while the lr schedule's step still advances
  (the reference's epoch scheduler steps regardless of skipped batches);
  ``nonfinite_count`` counts such steps and ``loss_sum`` sums the finite
  losses.

Unlike the JAX step, which returns a new state, the params (in the model)
and the Adam state (in the optimizer) are updated in place; the step reads
the loss on the host once, to decide whether to update. Dropout and drop
path draw from an explicit ``torch.Generator`` (on the CPU); the step's
augmentation (``AugmentConfig``: SpecAugment, then noise and roll, on the
batch's ``x`` before the forward, as the JAX step does) draws from another,
on the batch's device.

The epoch loop and the eval (``train_loop``, ``evaluate``,
``evaluate_ensemble``, ``average_ensemble_views``) follow the JAX module
too: per epoch, train, validate on the sigmoided scores, keep the best and
the latest checkpoint, and write ``result.csv``, ``progress.json``,
``stats_<epoch>.pickle`` and optionally the predictions under the
experiment directory.

On a mesh (``parallel/mesh.py``; ``mesh=`` of ``make_train_step``,
``evaluate`` and ``train_loop``), as the JAX step on its mesh: each rank
takes its slice of the global batch, draws the augmentation of the whole
global batch and keeps its rows; the grads are averaged over the 'data'
group (every rank's local batch has the same size), in one all-reduce; the
loss is the global mean, so the non-finite skip reads the same value on
every rank and they skip together. ``evaluate`` gathers the logits and
targets over 'data' (``parallel/multihost.py::to_host_global``), so the
metrics see the whole set; its loss is the mean over every rank's batches.
``init_train_state(..., mesh)`` lays the model out on the mesh after its
whole init (``shard_params``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from aum_tpu_torch.audio.augment import apply_noise_and_roll, apply_spec_augment, draw_augment
from aum_tpu_torch.train.metrics import calculate_stats, d_prime
from aum_tpu_torch.train.optim import TrainHyperParams, lr_at_step


# The seed of the host generator that picks each flexible-patch step's size.
FLEX_SEED = 1234


def flexible_patch_schedule(sizes, n_steps: int) -> list:
    """The patch sizes ``train_loop`` runs in its first ``n_steps`` steps."""
    rng = np.random.default_rng(FLEX_SEED)
    return [sizes[int(rng.integers(len(sizes)))] for _ in range(n_steps)]


@dataclasses.dataclass
class TrainState:
    """What one train step reads and advances. ``model`` holds the params and
    ``optimizer`` the Adam moments and count; ``step`` drives the schedule."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    loss_sum: float = 0.0
    nonfinite_count: int = 0


def reset_loss_accum(state: TrainState) -> TrainState:
    """Zero the epoch-loss accumulators (start of each epoch)."""
    return dataclasses.replace(state, loss_sum=0.0, nonfinite_count=0)


def init_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     mesh=None) -> TrainState:
    """The state of ``model`` and ``optimizer``; with ``mesh``, the model is
    first laid out on it (its whole init sliced, ``shard_params``) and the
    optimizer rebuilt with its defaults over the sliced parameters."""
    if mesh is not None and getattr(model, "mesh", None) is not mesh:
        from aum_tpu_torch.parallel.mesh import shard_params

        shard_params(model, mesh)
        optimizer = type(optimizer)(model.parameters(), **optimizer.defaults)
    return TrainState(model=model, optimizer=optimizer)


def _rows(tree, r: int, b: int):
    """Rows [r·b, (r+1)·b) of every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree[r * b:(r + 1) * b]
    if isinstance(tree, dict):
        return {k: _rows(v, r, b) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rows(v, r, b) for v in tree)
    return tree


def average_grads(params, group, n: int) -> None:
    """Average the grads of ``params`` over ``group`` (``n`` ranks) in one
    all-reduce of their flat concatenation, per dtype."""
    from aum_tpu_torch.parallel import collectives

    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        collectives.all_reduce(flat, group, tag="dp_grads").div_(n)
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad.copy_(g.view_as(p.grad))


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Train-time augmentation of the step's input: SpecAugment with these
    mask parameters, then noise and roll."""

    freqm: int = 0
    timem: int = 0
    noise: bool = False


def apply_augment(x: torch.Tensor, draws: dict) -> torch.Tensor:
    """The step's augmentation of x from ``draw_augment``'s values:
    SpecAugment, then noise and roll."""
    if "spec_augment" in draws:
        x = apply_spec_augment(x, draws["spec_augment"])
    if "noise" in draws:
        x = apply_noise_and_roll(x, draws["noise"])
    return x


def loss_fn_of(loss_type: str) -> Callable:
    """Mean BCE-with-logits, or soft-label CE, on fp32 logits."""
    if loss_type == "BCE":
        def f(logits, labels):
            return F.binary_cross_entropy_with_logits(logits.float(), labels.float())
    elif loss_type == "CE":
        def f(logits, labels):
            return -(labels.float() * F.log_softmax(logits.float(), dim=-1)).sum(-1).mean()
    else:
        raise ValueError(loss_type)
    return f


def make_train_step(hp: TrainHyperParams, steps_per_epoch: int,
                    loss_type: str = "BCE", augment: AugmentConfig = AugmentConfig(),
                    nan2num: bool = False, accum_steps: int = 1,
                    generator: torch.Generator | None = None,
                    aug_generator: torch.Generator | None = None,
                    patch_size=None, strides=None, mesh=None) -> Callable:
    """(state, batch) -> (state, loss) for batch {'x': (B, T, F), 'y': (B, C)}.

    ``loss`` is the step's mean loss, a 0-d fp32 tensor on the batch's
    device. ``generator`` feeds the model's dropout and drop path,
    ``aug_generator`` (on the batch's device) the augmentation, which needs
    it. ``patch_size`` runs the model at that patch size, with ``strides``
    (the patch size unless given): the flexible-patch step of one size.
    On ``mesh`` the batch is this rank's slice and ``loss`` the global mean.
    """
    if (augment.freqm or augment.timem or augment.noise) and aug_generator is None:
        raise ValueError("an augmenting train step needs aug_generator")
    loss_of = loss_fn_of(loss_type)
    model_kwargs = {}
    if patch_size is not None:
        model_kwargs = {"patch_size": patch_size,
                        "strides": strides if strides is not None else patch_size}

    n_data = mesh.size("data") if mesh is not None else 1
    data_group = mesh.group("data") if mesh is not None else None

    def step_fn(state: TrainState, batch) -> tuple[TrainState, torch.Tensor]:
        model, opt = state.model, state.optimizer
        x, y = batch["x"], batch["y"]
        b = x.shape[0]
        draws = draw_augment(aug_generator, (b * n_data,) + tuple(x.shape[1:]), augment.freqm,
                             augment.timem, augment.noise)
        if n_data > 1:
            draws = _rows(draws, mesh.coord("data"), b)
        x = apply_augment(x, draws)
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch {x.shape[0]} not divisible by accum_steps={accum_steps}")
        opt.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        for xm, ym in zip(x.chunk(accum_steps), y.chunk(accum_steps)):
            micro = loss_of(model(xm, train=True, generator=generator, **model_kwargs), ym)
            if nan2num:
                micro = torch.nan_to_num(micro)
            (micro / accum_steps).backward()
            loss = loss + micro.detach()
        loss = loss / accum_steps
        if data_group is not None:
            from aum_tpu_torch.parallel import collectives

            average_grads(model.parameters(), data_group, n_data)
            loss = collectives.all_reduce(loss, data_group, tag="dp_loss") / n_data
        value = loss.item()
        finite = value == value and abs(value) != float("inf")
        if finite:
            for group in opt.param_groups:
                group["lr"] = lr_at_step(hp, state.step, steps_per_epoch)
            opt.step()
        opt.zero_grad(set_to_none=True)
        state.step += 1
        state.loss_sum += value if finite else 0.0
        state.nonfinite_count += 0 if finite else 1
        return state, loss

    return step_fn


def make_eval_step(model: torch.nn.Module) -> Callable:
    """x -> logits, without autograd."""

    def eval_fn(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x)

    return eval_fn


def sigmoid_np(x):
    return 1.0 / (1.0 + np.exp(-x))


def _np_loss(loss_type: str, logits: np.ndarray, labels: np.ndarray) -> float:
    """Host-side loss (numpy, fp64)."""
    x = logits.astype(np.float64)
    y = labels.astype(np.float64)
    if loss_type == "BCE":
        return float(np.mean(
            np.maximum(x, 0) - x * y + np.log1p(np.exp(-np.abs(x)))))
    lse = np.log(np.sum(np.exp(x - x.max(axis=-1, keepdims=True)), axis=-1)) \
        + x.max(axis=-1)
    return float(np.mean(lse - np.sum(x * y, axis=-1)))


def evaluate(
    eval_step: Callable,
    batches: Iterable,
    loss_type: str = "BCE",
    main_metric: str = "mAP",
    nan2num: bool = False,
    return_stats: bool = False,
    full_curves: bool = False,
    mesh=None,
):
    """Run eval over ``batches`` ({'x', 'y'} dicts) with ``eval_step`` (x ->
    logits), as the reference's ``validate_acc`` does. On ``mesh``, this
    rank's batches, gathered over 'data' at the end.

    The scores are the sigmoided logits, and, as in the reference, the val
    loss is taken on the *sigmoided* scores too. With ``nan2num``,
    non-finite logits become 0 / +-max before the sigmoid. Returns (metrics,
    scores, targets), and the per-class stats list when ``return_stats``
    (``full_curves`` adds the PR and ROC curves).
    """
    from aum_tpu_torch.data.pipeline import Prefetcher
    from aum_tpu_torch.parallel import collectives
    from aum_tpu_torch.parallel.multihost import to_host_global

    # This rank's logits and targets stay on the device and are gathered
    # over 'data' at the end (ranks may hold different numbers of batches);
    # the loss is the mean of every rank's batch losses.
    group = mesh.group("data") if mesh is not None else None
    logits, tgts, losses = [], [], []
    for batch in Prefetcher(iter(batches)):
        out = eval_step(batch["x"]).float()
        logits.append(out)
        tgts.append(batch["y"].float())
        scores = sigmoid_np(np.nan_to_num(out.cpu().numpy()) if nan2num else out.cpu().numpy())
        losses.append(_np_loss(loss_type, scores, tgts[-1].cpu().numpy()))
    device = tgts[0].device if tgts else torch.device("cpu")
    total = collectives.all_reduce(torch.tensor([sum(losses), len(losses)], dtype=torch.float64,
                                                device=device), group, tag="eval_loss")
    scores = to_host_global(torch.cat(logits), mesh)
    if nan2num:
        scores = np.nan_to_num(scores)
    targets = to_host_global(torch.cat(tgts), mesh)
    loss = float(total[0] / total[1]) if float(total[1]) else float("nan")
    return _eval_metrics(sigmoid_np(scores), targets, loss, main_metric, return_stats,
                         full_curves)


def _eval_metrics(scores, targets, loss: float, main_metric, return_stats, full_curves):
    stats = calculate_stats(scores, targets, full_curves=full_curves)
    m_ap = float(np.nanmean(np.array([s["AP"] for s in stats], dtype=np.float64)))
    m_auc = float(np.nanmean(np.array([s["auc"] for s in stats], dtype=np.float64)))
    metrics = {
        "mAP": m_ap,
        "AUC": m_auc,
        "acc": stats[0]["acc"],
        "d_prime": d_prime(m_auc) if 0 < m_auc < 1 else float("nan"),
        "loss": loss,
        "main": None,
    }
    metrics["main"] = metrics["acc" if main_metric == "acc" else "mAP"]
    if return_stats:
        return metrics, scores, targets, stats
    return metrics, scores, targets


def train_loop(
    state: TrainState,
    hp: TrainHyperParams,
    steps_per_epoch: int,
    train_batches: Callable[[int], Iterable],
    eval_batches: Callable[[], Iterable],
    n_epochs: int,
    loss_type: str = "BCE",
    main_metric: str = "mAP",
    augment: AugmentConfig = AugmentConfig(),
    nan2num: bool = False,
    continue_inf: bool = True,
    exp_dir: Optional[str] = None,
    checkpointer=None,
    log_every: int = 50,
    print_fn=print,
    save_predictions: bool = False,
    flexible_patch_sizes=None,
    accum_steps: int = 1,
    profile_dir: Optional[str] = None,
    profile_steps: tuple = (3, 8),
    start_epoch: int = 1,
    generator: torch.Generator | None = None,
    aug_generator: torch.Generator | None = None,
    mesh=None,
):
    """Epoch loop: train, validate, track the best epoch, checkpoint.

    Artifacts per epoch under ``exp_dir``: ``result.csv``,
    ``progress.json``, ``stats_<epoch>.pickle`` (the per-class stats with
    their curves) and, with ``save_predictions``,
    ``predictions/predictions_<epoch>.csv`` and ``target.csv``.

    A non-finite loss skips the update (the step's rule); with
    ``continue_inf=False`` (the reference's default: exit on inf) the loop
    raises at the first one. The epoch's ``train_loss`` is the mean over its
    finite steps. ``start_epoch`` > 1 resumes a run: epoch labels,
    artifacts and shuffle orders continue from there. With ``profile_dir``,
    steps ``profile_steps`` of epoch 1 are traced (``train/profiling.py``).
    With ``flexible_patch_sizes`` each train step runs at a size drawn from
    them by ``np.random.default_rng(FLEX_SEED)`` (``flexible_patch_schedule``),
    as in JAX; the validation runs at the model's own patch size. On
    ``mesh`` the steps and the validation run on it (``make_train_step``,
    ``evaluate``); the caller gives ``exp_dir`` and ``print_fn`` to the
    rank that writes, and the checkpointer gathers on every rank.
    """
    from aum_tpu_torch.data.pipeline import Prefetcher
    from aum_tpu_torch.train.profiling import trace

    if flexible_patch_sizes:
        # One step per size; each step's size is drawn as JAX draws it.
        steps = {ps: make_train_step(hp, steps_per_epoch, loss_type, augment, nan2num,
                                     accum_steps, generator, aug_generator, patch_size=ps,
                                     mesh=mesh)
                 for ps in flexible_patch_sizes}
        flex_rng = np.random.default_rng(FLEX_SEED)

        def step_fn(state, batch):
            ps = flexible_patch_sizes[int(flex_rng.integers(len(flexible_patch_sizes)))]
            return steps[ps](state, batch)
    else:
        step_fn = make_train_step(hp, steps_per_epoch, loss_type, augment, nan2num,
                                  accum_steps, generator, aug_generator, mesh=mesh)
    eval_fn = make_eval_step(state.model)
    history = []
    progress = []
    best = {"epoch": 0, "main": -np.inf}
    for epoch in range(start_epoch, n_epochs + 1):
        state = reset_loss_accum(state)
        t_epoch = time.time()
        n_clips = n_steps = 0
        with contextlib.ExitStack() as prof:
            for i, batch in enumerate(Prefetcher(train_batches(epoch))):
                if profile_dir is not None and epoch == 1 and i == profile_steps[0]:
                    prof.enter_context(trace(profile_dir))
                state, loss = step_fn(state, batch)
                n_clips += int(batch["x"].shape[0]) * (mesh.size("data") if mesh else 1)
                n_steps += 1
                if state.nonfinite_count and not continue_inf:
                    raise RuntimeError(
                        f"{state.nonfinite_count} non-finite train loss(es) by epoch {epoch} "
                        f"step {i + 1} (continue_inf=False: the reference exits on inf)")
                if profile_dir is not None and epoch == 1 and i + 1 == profile_steps[1]:
                    prof.close()
                    print_fn(f"profiler trace (steps {profile_steps[0]}-{profile_steps[1]}) "
                             f"-> {profile_dir}")
                if (i + 1) % log_every == 0:
                    print_fn(f"epoch {epoch} step {i + 1}: loss {float(loss):.4f}")
        train_secs = time.time() - t_epoch
        n_finite = n_steps - state.nonfinite_count
        epoch_loss = state.loss_sum / n_finite if n_finite else float("nan")
        metrics, scores, targets, epoch_stats = evaluate(
            eval_fn, eval_batches(), loss_type, main_metric, nan2num=nan2num,
            return_stats=True, full_curves=True, mesh=mesh)
        metrics["epoch"] = epoch
        metrics["train_loss"] = epoch_loss if n_steps else None
        metrics["clips_per_sec"] = n_clips / train_secs if train_secs > 0 else 0.0
        history.append(metrics)
        print_fn(f"epoch {epoch}: {metrics}")
        if metrics["main"] > best["main"]:
            best = {"epoch": epoch, "main": metrics["main"]}
            if checkpointer is not None:
                checkpointer.save_best(state, epoch, metrics)
        if checkpointer is not None:
            checkpointer.save_latest(state, epoch, metrics)
        if exp_dir is not None:
            _write_result_csv(exp_dir, history)
            progress.append([epoch, state.step, best["epoch"], float(best["main"])])
            with open(os.path.join(exp_dir, "progress.json"), "w") as f:
                json.dump(progress, f)
            with open(os.path.join(exp_dir, f"stats_{epoch}.pickle"), "wb") as f:
                pickle.dump(epoch_stats, f)
            if save_predictions:
                pdir = os.path.join(exp_dir, "predictions")
                os.makedirs(pdir, exist_ok=True)
                np.savetxt(os.path.join(pdir, f"predictions_{epoch}.csv"), scores,
                           delimiter=",")
                if epoch == 1:
                    np.savetxt(os.path.join(pdir, "target.csv"), targets, delimiter=",")
    return state, history, best


def _write_result_csv(exp_dir: str, history):
    """result.csv: one row per epoch."""
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "result.csv"), "w") as f:
        f.write("epoch,mAP,AUC,acc,d_prime,loss,train_loss\n")
        for m in history:
            f.write(f"{m['epoch']},{m['mAP']},{m['AUC']},{m['acc']},"
                    f"{m['d_prime']},{m['loss']},{m['train_loss']}\n")


def evaluate_ensemble(
    eval_step: Callable,
    model: torch.nn.Module,
    state_dicts: list,
    batches_fn: Callable[[], Iterable],
    loss_type: str = "BCE",
    main_metric: str = "mAP",
    nan2num: bool = False,
):
    """Cumulative prediction ensemble (the reference's ``validate_ensemble``):
    load each (one-card) state dict into ``model`` in turn (``eval_step``
    runs it; sliced for this rank on a mesh), average the sigmoid scores of
    the first k and score that ensemble."""
    cum = None
    results = []
    from aum_tpu_torch.parallel.mesh import load_full_state_dict

    for k, sd in enumerate(state_dicts, start=1):
        load_full_state_dict(model, sd)
        _, scores, targets = evaluate(eval_step, batches_fn(), loss_type, main_metric,
                                      nan2num=nan2num, mesh=getattr(model, "mesh", None))
        cum = scores if cum is None else cum + scores
        stats = calculate_stats(cum / k, targets)
        ap = np.nanmean([s["AP"] for s in stats])
        results.append({"n_models": k, "mAP": float(ap), "acc": stats[0]["acc"]})
    return results


def average_ensemble_views(scores: np.ndarray, record_index: np.ndarray):
    """Average test-time ensemble-view predictions per record (the EPIC
    NUM_ENSEMBLE_VIEWS protocol)."""
    uniq = np.unique(record_index)
    out = np.zeros((len(uniq), scores.shape[1]), scores.dtype)
    for i, r in enumerate(uniq):
        out[i] = scores[record_index == r].mean(axis=0)
    return uniq, out
