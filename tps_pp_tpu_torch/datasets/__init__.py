"""Recognition datasets, loaders and the test pipeline (counterpart of
``tps_pp_tpu/datasets``, test mode)."""
from . import pipelines  # noqa: F401 (registration)
from .loader import HardDiskLoader, LineJsonParser, LineStrParser, LmdbLoader
from .ocr_dataset import (DataLoader, OCRDataset, UniformConcatDataset,
                          build_dataset)
from .pipelines.transforms import Compose

__all__ = ['HardDiskLoader', 'LmdbLoader', 'LineStrParser', 'LineJsonParser',
           'OCRDataset', 'UniformConcatDataset', 'DataLoader',
           'build_dataset', 'Compose']
