"""The data pipeline (counterpart of ``repro.data``)."""
from .pipeline import (DataConfig, DataLoader, SyntheticTokenDataset,
                       make_batch_shapes)

__all__ = ["DataConfig", "DataLoader", "SyntheticTokenDataset",
           "make_batch_shapes"]
