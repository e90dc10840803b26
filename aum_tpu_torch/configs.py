"""Experiment configuration: the published training recipes.

Counterpart of ``aum_tpu/configs.py`` (a copy: the port imports nothing of
the JAX package). Each ``ExperimentConfig`` bundles the model variant, the
audio pipeline and the training hyperparameters; ``RECIPES`` holds the
published per-dataset recipes (the reference's
``exps/*/aum-base_scratch-*.sh``), with each dataset's normalization
statistics. ``model_config``, ``audio_conf`` and ``train_hp`` build the
port's ``AudioMambaConfig``, ``AudioConf`` and ``TrainHyperParams``.

The variant helpers at the end are copied too: an AudioSet-pretrained AuM,
the AST baseline, and the small Bi-Bi from an ImageNet ViM
(``run.build_model`` ports their checkpoints).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from aum_tpu_torch.data.datasets import AudioConf
from aum_tpu_torch.models.audio_mamba import AudioMambaConfig
from aum_tpu_torch.train.optim import TrainHyperParams

# Fixed seed table (run.py:28-30).
SEEDS = [1741571, 1331626, 1116284, 1236867, 1751863, 1250406, 1156190,
         1275302, 1718303, 1751336]


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    dataset: str
    model: str = "aum"                  # aum | ast
    model_type: str = "base"            # base | small | tiny
    aum_type: str = "Fo-Bi"             # Fo-Fo | Fo-Bi | Bi-Bi
    n_class: int = 527
    audio_length: int = 1024
    melbins: int = 128
    fstride: int = 16
    tstride: int = 16
    fpatch_size: int = 16
    tpatch_size: int = 16
    batch_size: int = 12
    # Gradient-accumulation microsteps: batch_size must divide evenly; >1
    # reproduces multi-GPU effective batches on one chip (see
    # train.loop.make_train_step). Optimizer bs-scaling uses the full
    # batch_size either way (matching the reference's effective-batch
    # semantics, traintest.py:26-34).
    accum_steps: int = 1
    lr: float = 1e-5
    n_epochs: int = 5
    freqm: int = 48
    timem: int = 48
    mixup: float = 0.0
    bal: bool = False                   # balanced (weighted) sampling
    dataset_mean: float = -4.2677393
    dataset_std: float = 4.5689974
    noise: bool = False
    fshift: float = 10.0                # fbank frame shift in ms (--fshift)
    metrics: str = "mAP"                # mAP | acc
    loss: str = "BCE"                   # BCE | CE
    warmup: bool = True
    lrscheduler_start: int = 2
    lrscheduler_step: int = 1
    lrscheduler_decay: float = 0.5
    weight_decay: float = 5e-7
    bs_scale_factor: int = 1
    dtype: str = "bfloat16"
    # NaN-loss coercion to 0 (traintest.py:154-155) and whether to keep
    # training through a non-finite loss (traintest.py:157-165; the
    # reference exits by default — continue_inf=False reproduces that,
    # continue_inf=True skips the update and keeps going).
    nan2num: bool = False
    continue_inf: bool = False
    seed: int = SEEDS[0]
    depth: Optional[int] = None         # override model depth (testing/ablation)
    # Stochastic depth rate (reference --aum_drop_path, run.py:85 ->
    # drop_path_rate with the linear per-layer decay rule). All published
    # recipes use 0.
    aum_drop_path: float = 0.0
    flexible_patch_sizes: Optional[Tuple[int, ...]] = None  # flexible training
    # pretrained init
    imagenet_pretrain_path: Optional[str] = None
    # Checkpoint-dict key holding the ViM state dict (reference
    # --imagenet_pretrain_modelkey, run.py:70; 'model' for released ViM).
    imagenet_pretrain_modelkey: str = "model"
    aum_pretrain_path: Optional[str] = None
    # Pretrain-time strides for the pos-embed grid inference when they
    # differ from this run's patch size (reference --aum_pretrain_fstride/
    # tstride, run.py:75-76). None falls back to the CHECKPOINT'S OWN patch
    # size (mamba_models.py:409-414 semantics in port_aum_state_dict) — the
    # reference CLI always passes its argparse default 16, which agrees only
    # because released checkpoints use patch 16; for a non-16-patch pretrain
    # checkpoint pass the stride explicitly to match a reference run
    # (ADVICE r4).
    aum_pretrain_fstride: Optional[int] = None
    aum_pretrain_tstride: Optional[int] = None
    # AST pretrain init (reference --ast_pretrain/--ast_pretrain_path +
    # the --ast_fstride/--ast_tstride/--ast_input_fdim/--ast_input_tdim
    # geometry, run.py:100-107): path to a nested AST audio checkpoint
    # (timm model under `v.`, head under `mlp_head.`); the pos embed is
    # retargeted from the pretrain grid these fields describe. Defaults
    # match the reference flags.
    ast_pretrain_path: Optional[str] = None
    ast_pretrain_fstride: int = 16
    ast_pretrain_tstride: int = 16
    ast_pretrain_input_fdim: int = 128
    ast_pretrain_input_tdim: int = 1024

    def model_config(self) -> AudioMambaConfig:
        cfg = AudioMambaConfig.from_variant(
            self.model_type, self.aum_type,
            spectrogram_size=(self.melbins, self.audio_length),
            patch_size=(self.fpatch_size, self.tpatch_size),
            strides=(self.fstride, self.tstride),
            num_classes=self.n_class, dtype=self.dtype,
            drop_path_rate=self.aum_drop_path)
        if self.depth is not None:
            cfg = dataclasses.replace(cfg, depth=self.depth)
        return cfg

    def audio_conf(self, train: bool) -> AudioConf:
        return AudioConf(
            num_mel_bins=self.melbins, target_length=self.audio_length,
            freqm=self.freqm if train else 0,
            timem=self.timem if train else 0,
            mixup=self.mixup if train else 0.0,
            dataset=self.dataset, mean=self.dataset_mean,
            std=self.dataset_std, noise=self.noise and train,
            fshift=self.fshift)

    def train_hp(self) -> TrainHyperParams:
        return TrainHyperParams(
            lr=self.lr, weight_decay=self.weight_decay,
            bs_scale_factor=self.bs_scale_factor, warmup=self.warmup,
            lrscheduler_start=self.lrscheduler_start,
            lrscheduler_step=self.lrscheduler_step,
            lrscheduler_decay=self.lrscheduler_decay,
            loss=self.loss, n_epochs=self.n_epochs,
            epic=self.dataset == "epic_sounds")


def _r(name, **kw) -> ExperimentConfig:
    return ExperimentConfig(name=name, **kw)


# Published recipes (exps/*/aum-base_scratch-*.sh; SURVEY.md §6 table).
RECIPES = {
    "audioset/aum-base_scratch": _r(
        "aum-base_scratch-audioset", dataset="audioset", n_class=527,
        lr=1e-5, n_epochs=5, batch_size=12, freqm=48, timem=192, mixup=0.5,
        bal=True, metrics="mAP", loss="BCE", warmup=True,
        lrscheduler_start=2, lrscheduler_step=1, lrscheduler_decay=0.5,
        dataset_mean=-4.2677393, dataset_std=4.5689974),
    "as20k/aum-base_scratch": _r(
        "aum-base_scratch-as_20k", dataset="audioset", n_class=527,
        lr=5e-5, n_epochs=25, batch_size=12, freqm=48, timem=192, mixup=0.5,
        metrics="mAP", loss="BCE", warmup=True,
        lrscheduler_start=10, lrscheduler_step=5, lrscheduler_decay=0.5,
        dataset_mean=-4.2677393, dataset_std=4.5689974),
    "vggsound/aum-base_scratch": _r(
        "aum-base_scratch-vggsound", dataset="vggsound", n_class=309,
        lr=1e-5, n_epochs=20, batch_size=12, freqm=48, timem=192, mixup=0.0,
        metrics="acc", loss="BCE", warmup=True,
        lrscheduler_start=5, lrscheduler_step=2, lrscheduler_decay=0.75,
        dataset_mean=-5.0767093, dataset_std=4.4533687),
    "voxceleb/aum-base_scratch": _r(
        "aum-base_scratch-voxceleb", dataset="voxceleb", n_class=1251,
        lr=1e-5, n_epochs=20, batch_size=12, freqm=48, timem=192, mixup=0.0,
        metrics="acc", loss="CE", warmup=True,
        lrscheduler_start=5, lrscheduler_step=2, lrscheduler_decay=0.75,
        dataset_mean=-3.7614744, dataset_std=4.2011642),
    "speechcommands/aum-base_scratch": _r(
        "aum-base_scratch-spc_v2", dataset="speechcommands", n_class=35,
        audio_length=128, lr=2.5e-4, n_epochs=30, batch_size=128,
        freqm=48, timem=48, mixup=0.6, noise=True,
        metrics="acc", loss="BCE", warmup=False,
        lrscheduler_start=5, lrscheduler_step=1, lrscheduler_decay=0.85,
        dataset_mean=-6.845978, dataset_std=5.5654526),
    "epic_sounds/aum-base_scratch": _r(
        "aum-base_scratch-epic_sounds", dataset="epic_sounds", n_class=44,
        lr=1e-5, n_epochs=30, batch_size=12, freqm=48, timem=192,
        metrics="acc", loss="CE", warmup=True,
        dataset_mean=-6.627534, dataset_std=4.4917786),
}


def audioset_pretrained_variant(key: str, aum_ckpt: str) -> ExperimentConfig:
    """exps/*/aum-base_audioset-*.sh: base Fo-Bi initialized from an
    AudioSet-pretrained AuM checkpoint."""
    base = RECIPES[key]
    return dataclasses.replace(
        base, name=base.name.replace("base_scratch", "base_audioset"),
        aum_pretrain_path=aum_ckpt)


def ast_variant(key: str, **kw) -> ExperimentConfig:
    """exps/*/ast-*.sh: the AST baseline on the same recipe (run.py:196-223);
    AST uses 10x10 strides by default (fstride/tstride flags)."""
    base = RECIPES[key]
    return dataclasses.replace(
        base, name=base.name.replace("aum", "ast"), model="ast",
        fstride=10, tstride=10, **kw)


def small_imagenet_variant(key: str, vim_path: str) -> ExperimentConfig:
    """exps/*/aum-small_imgnet-*.sh: small Bi-Bi from an ImageNet ViM init."""
    base = RECIPES[key]
    return dataclasses.replace(
        base, name=base.name.replace("base_scratch", "small_imgnet"),
        model_type="small", aum_type="Bi-Bi",
        imagenet_pretrain_path=vim_path)
