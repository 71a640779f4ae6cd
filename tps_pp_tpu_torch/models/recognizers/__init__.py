from .abinet import ABINetRecognizerModule
from .encode_decode import EncodeDecodeRecognizer

__all__ = ['ABINetRecognizerModule', 'EncodeDecodeRecognizer']
