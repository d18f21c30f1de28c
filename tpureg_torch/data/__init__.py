from .analyze import AnalyzeHeader, read_analyze
from .pipeline import (
    RealPairsDataset,
    VolumeSliceSource,
    list_pairs,
    real_pairs_dataset,
)

__all__ = [
    "AnalyzeHeader",
    "read_analyze",
    "RealPairsDataset",
    "VolumeSliceSource",
    "list_pairs",
    "real_pairs_dataset",
]
