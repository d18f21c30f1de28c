from .analyze import AnalyzeHeader, read_analyze
from .pipeline import (
    RealPairsDataset,
    SliceDataset,
    VolumeSliceSource,
    eval_random_dataset,
    list_pairs,
    real_pairs_dataset,
    split_volumes,
    synth_image_batch,
    volume2slices_datasets,
)
from .synth import random_pair_batch

__all__ = [
    "AnalyzeHeader",
    "read_analyze",
    "RealPairsDataset",
    "SliceDataset",
    "VolumeSliceSource",
    "eval_random_dataset",
    "list_pairs",
    "real_pairs_dataset",
    "split_volumes",
    "synth_image_batch",
    "volume2slices_datasets",
    "random_pair_batch",
]
