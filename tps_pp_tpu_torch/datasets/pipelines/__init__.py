from . import (cv_ops, extras, ocr_seg_targets, test_time_aug,  # noqa: F401
               tps_aug, transforms)
from .extras import (FancyPCA, OnlineCropOCR, OpencvToPil, PilToOpencv,
                     RandomPaddingOCR, RandomRotateImageBox)
from .ocr_seg_targets import OCRSegTargets
from .test_time_aug import MultiRotateAugOCR, merge_aug_results
from .transforms import (Collect, ColorJitter, Compose, DefaultFormatBundle,
                         GaussNoise, LoadImageFromFile, LoadImageFromNdarray,
                         MotionBlur, Normalize, NormalizeOCR, OneOfWrapper,
                         PyramidRescale, RandomAffine, RandomPerspective,
                         RandomRotateTextDet, RandomWrapper, ResizeOCR,
                         ToTensorOCR, TorchVisionWrapper)
from .tps_aug import Curve, Distort, Stretch

__all__ = ['Collect', 'ColorJitter', 'Compose', 'Curve',
           'DefaultFormatBundle', 'Distort', 'FancyPCA', 'GaussNoise',
           'LoadImageFromFile', 'LoadImageFromNdarray', 'MotionBlur',
           'MultiRotateAugOCR', 'Normalize', 'NormalizeOCR', 'OCRSegTargets',
           'OneOfWrapper', 'OnlineCropOCR', 'OpencvToPil', 'PilToOpencv',
           'PyramidRescale', 'RandomAffine', 'RandomPaddingOCR',
           'RandomPerspective', 'RandomRotateImageBox', 'RandomRotateTextDet',
           'RandomWrapper', 'ResizeOCR', 'Stretch', 'ToTensorOCR',
           'TorchVisionWrapper', 'merge_aug_results']
