from .base import BaseConvertor
from .attn import AttnConvertor
from .abi import ABIConvertor
from .ctc import CTCConvertor
from .mask import Mask_ABIConvertor, MaskCTCConvertor
from .seg import SegConvertor

__all__ = ['BaseConvertor', 'AttnConvertor', 'ABIConvertor', 'CTCConvertor',
           'MaskCTCConvertor', 'Mask_ABIConvertor', 'SegConvertor']
