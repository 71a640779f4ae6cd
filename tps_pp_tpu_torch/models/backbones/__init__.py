from .resnet_abi import ResNetABI_v2_large

__all__ = ['ResNetABI_v2_large']
