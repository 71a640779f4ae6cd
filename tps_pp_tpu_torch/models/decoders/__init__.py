from .base import beam_decode, greedy_decode
from .nrtr import NRTRDecoder

__all__ = ['beam_decode', 'greedy_decode', 'NRTRDecoder']
