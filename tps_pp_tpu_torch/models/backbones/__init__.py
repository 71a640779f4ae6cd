from .misc import NRTRModalityTransform, ShallowCNN
from .resnet31 import ResNet31OCR
from .resnet_abi import ResNetABI, ResNetABI_v2_large
from .vgg import VeryDeepVgg

__all__ = ['NRTRModalityTransform', 'ResNet31OCR', 'ResNetABI',
           'ResNetABI_v2_large', 'ShallowCNN', 'VeryDeepVgg']
