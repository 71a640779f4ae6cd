from . import test_time_aug, transforms  # noqa: F401 (registration)
from .test_time_aug import MultiRotateAugOCR, merge_aug_results
from .transforms import (Collect, Compose, LoadImageFromFile,
                         LoadImageFromNdarray, NormalizeOCR, ResizeOCR,
                         ToTensorOCR)

__all__ = ['Collect', 'Compose', 'LoadImageFromFile', 'LoadImageFromNdarray',
           'MultiRotateAugOCR', 'NormalizeOCR', 'ResizeOCR', 'ToTensorOCR',
           'merge_aug_results']
