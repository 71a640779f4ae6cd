from .resnet_abi import ResNetABI, ResNetABI_v2_large
from .vgg import VeryDeepVgg

__all__ = ['ResNetABI', 'ResNetABI_v2_large', 'VeryDeepVgg']
