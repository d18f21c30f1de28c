from .analyze import AnalyzeHeader, read_analyze
from .pipeline import (
    VOLUME_SIZE,
    RealPairsDataset,
    SliceDataset,
    VolumePairDataset,
    VolumeSliceSource,
    eval_random_dataset,
    list_pairs,
    random_rigid_draws,
    real_pairs_dataset,
    split_volumes,
    synth_image_batch,
    volume2slices_datasets,
    volume_dataset,
)
from .synth import random_pair_batch, random_volume_batch

__all__ = [
    "VOLUME_SIZE",
    "AnalyzeHeader",
    "read_analyze",
    "RealPairsDataset",
    "SliceDataset",
    "VolumePairDataset",
    "VolumeSliceSource",
    "eval_random_dataset",
    "list_pairs",
    "random_rigid_draws",
    "real_pairs_dataset",
    "split_volumes",
    "synth_image_batch",
    "volume2slices_datasets",
    "volume_dataset",
    "random_pair_batch",
    "random_volume_batch",
]
