"""Synthetic datasets with the paper's data characteristics, and the
restartable batch loaders."""
from repro_torch.data.loader import (FeatureBatchLoader, LoaderState,
                                     TokenBatchLoader)

__all__ = ["LoaderState", "TokenBatchLoader", "FeatureBatchLoader"]
