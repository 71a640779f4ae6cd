from .resnet_abi import ResNetABI, ResNetABI_v2_large

__all__ = ['ResNetABI', 'ResNetABI_v2_large']
