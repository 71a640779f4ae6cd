from .abi import ABIVisionModel, PostNormTransformerLayer, TransformerEncoder
from .nrtr import NRTREncoder

__all__ = ['ABIVisionModel', 'NRTREncoder', 'PostNormTransformerLayer',
           'TransformerEncoder']
