from .abi import ABILanguageDecoder, ABIVisionDecoder
from .base import beam_decode, greedy_decode
from .nrtr import NRTRDecoder

__all__ = ['ABILanguageDecoder', 'ABIVisionDecoder', 'beam_decode',
           'greedy_decode', 'NRTRDecoder']
