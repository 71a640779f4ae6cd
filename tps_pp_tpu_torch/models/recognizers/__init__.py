from .encode_decode import EncodeDecodeRecognizer

__all__ = ['EncodeDecodeRecognizer']
