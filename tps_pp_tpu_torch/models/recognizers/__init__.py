from .abinet import ABINetRecognizerModule
from .encode_decode import EncodeDecodeRecognizer
from .seg import FPNOCR, SegHead, SegLoss, SegRecognizerModule

__all__ = ['ABINetRecognizerModule', 'EncodeDecodeRecognizer', 'FPNOCR',
           'SegHead', 'SegLoss', 'SegRecognizerModule']
