from . import cv_ops, test_time_aug, transforms  # noqa: F401 (registration)
from .test_time_aug import MultiRotateAugOCR, merge_aug_results
from .transforms import (Collect, ColorJitter, Compose, GaussNoise,
                         LoadImageFromFile, LoadImageFromNdarray, MotionBlur,
                         NormalizeOCR, OneOfWrapper, PyramidRescale,
                         RandomAffine, RandomPerspective, RandomRotateTextDet,
                         RandomWrapper, ResizeOCR, ToTensorOCR,
                         TorchVisionWrapper)

__all__ = ['Collect', 'ColorJitter', 'Compose', 'GaussNoise',
           'LoadImageFromFile', 'LoadImageFromNdarray', 'MotionBlur',
           'MultiRotateAugOCR', 'NormalizeOCR', 'OneOfWrapper',
           'PyramidRescale', 'RandomAffine', 'RandomPerspective',
           'RandomRotateTextDet', 'RandomWrapper', 'ResizeOCR',
           'ToTensorOCR', 'TorchVisionWrapper', 'merge_aug_results']
