from . import cv_ops, ocr_seg_targets, test_time_aug, transforms  # noqa: F401
from .ocr_seg_targets import OCRSegTargets
from .test_time_aug import MultiRotateAugOCR, merge_aug_results
from .transforms import (Collect, ColorJitter, Compose, DefaultFormatBundle,
                         GaussNoise, LoadImageFromFile, LoadImageFromNdarray,
                         MotionBlur, Normalize, NormalizeOCR, OneOfWrapper,
                         PyramidRescale, RandomAffine, RandomPerspective,
                         RandomRotateTextDet, RandomWrapper, ResizeOCR,
                         ToTensorOCR, TorchVisionWrapper)

__all__ = ['Collect', 'ColorJitter', 'Compose', 'DefaultFormatBundle',
           'GaussNoise', 'LoadImageFromFile', 'LoadImageFromNdarray',
           'MotionBlur', 'MultiRotateAugOCR', 'Normalize', 'NormalizeOCR',
           'OCRSegTargets', 'OneOfWrapper', 'PyramidRescale',
           'RandomAffine', 'RandomPerspective', 'RandomRotateTextDet',
           'RandomWrapper', 'ResizeOCR', 'ToTensorOCR', 'TorchVisionWrapper',
           'merge_aug_results']
