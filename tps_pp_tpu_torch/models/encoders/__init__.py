from .abi import ABIVisionModel, PostNormTransformerLayer, TransformerEncoder
from .nrtr import NRTREncoder
from .sar import ChannelReductionEncoder, SAREncoder

__all__ = ['ABIVisionModel', 'ChannelReductionEncoder', 'NRTREncoder',
           'PostNormTransformerLayer', 'SAREncoder', 'TransformerEncoder']
