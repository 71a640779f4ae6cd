"""Recognition, detection, KIE and NER datasets, loaders, the pipelines
and the batcher (counterpart of ``tps_pp_tpu/datasets``)."""
from . import pipelines  # noqa: F401 (registration)
from .kie_dataset import KIEDataset, NerDataset, OpensetKIEDataset
from .loader import (HardDiskLoader, LineJsonParser, LineStrParser,
                     LmdbLoader, PackedLoader)
from .ocr_seg_dataset import OCRSegDataset, parse_char_anno
from .ocr_dataset import (DataLoader, OCRDataset, UniformConcatDataset,
                          build_dataset, sample_key, seeded_rngs)
from .pipelines.transforms import Compose
from .textdet_dataset import TextDetDataset

__all__ = ['HardDiskLoader', 'LmdbLoader', 'PackedLoader', 'LineStrParser',
           'LineJsonParser',
           'OCRDataset', 'OCRSegDataset', 'UniformConcatDataset',
           'DataLoader', 'build_dataset', 'Compose', 'parse_char_anno',
           'sample_key', 'seeded_rngs', 'TextDetDataset', 'KIEDataset',
           'OpensetKIEDataset', 'NerDataset']
