from aum_tpu_torch.data.datasets import (
    AudioConf,
    AudioJsonDataset,
    load_wav,
    make_index_dict,
    make_name_dict,
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
    "Prefetcher",
    "balanced_sample_weights",
    "load_wav",
    "make_featurize",
    "make_index_dict",
    "make_name_dict",
]
