from .abi import ABILanguageDecoder, ABIVisionDecoder
from .base import beam_decode, greedy_decode
from .crnn import CRNNDecoder
from .nrtr import NRTRDecoder
from .robust_scanner import (PositionAttentionDecoder, RobustScannerDecoder,
                             SequenceAttentionDecoder)
from .sar import (ParallelSARDecoder, ParallelSARDecoderWithBS,
                  SequentialSARDecoder)
from .tf_common import TFCommonDecoder, TFCommonDecoderLayer

__all__ = ['ABILanguageDecoder', 'ABIVisionDecoder', 'beam_decode',
           'CRNNDecoder', 'greedy_decode', 'NRTRDecoder',
           'ParallelSARDecoder', 'ParallelSARDecoderWithBS',
           'PositionAttentionDecoder', 'RobustScannerDecoder',
           'SequenceAttentionDecoder', 'SequentialSARDecoder',
           'TFCommonDecoder', 'TFCommonDecoderLayer']
