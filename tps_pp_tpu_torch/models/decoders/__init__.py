from .base import greedy_decode
from .nrtr import NRTRDecoder

__all__ = ['greedy_decode', 'NRTRDecoder']
