from .abi import ABIVisionModel, PostNormTransformerLayer, TransformerEncoder
from .nrtr import NRTREncoder
from .sar import ChannelReductionEncoder, SAREncoder
from .satrn import SatrnEncoder

__all__ = ['ABIVisionModel', 'ChannelReductionEncoder', 'NRTREncoder',
           'PostNormTransformerLayer', 'SAREncoder', 'SatrnEncoder',
           'TransformerEncoder']
