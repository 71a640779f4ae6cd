from .abi import ABILanguageDecoder, ABIVisionDecoder
from .base import beam_decode, greedy_decode
from .crnn import CRNNDecoder
from .nrtr import NRTRDecoder

__all__ = ['ABILanguageDecoder', 'ABIVisionDecoder', 'beam_decode',
           'CRNNDecoder', 'greedy_decode', 'NRTRDecoder']
