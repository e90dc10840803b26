from aum_tpu_torch.data.datasets import (
    AudioConf,
    AudioJsonDataset,
    load_wav,
    make_index_dict,
    make_name_dict,
)
from aum_tpu_torch.data.epic import (
    EpicAudioConfig,
    EpicBatchPipeline,
    EpicFlexiBatchPipeline,
    EpicSoundsDataset,
    EpicSoundsRecord,
    make_epic_featurize,
)
from aum_tpu_torch.data.pipeline import (
    BatchPipeline,
    Prefetcher,
    balanced_sample_weights,
    make_featurize,
)

__all__ = [
    "AudioConf",
    "AudioJsonDataset",
    "BatchPipeline",
    "EpicAudioConfig",
    "EpicBatchPipeline",
    "EpicFlexiBatchPipeline",
    "EpicSoundsDataset",
    "EpicSoundsRecord",
    "Prefetcher",
    "balanced_sample_weights",
    "load_wav",
    "make_epic_featurize",
    "make_featurize",
    "make_index_dict",
    "make_name_dict",
]
