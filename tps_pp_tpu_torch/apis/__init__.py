from .flagship import FLAGSHIP_INPUT, TINY_INPUT, nrtr_tps_pp_cfg
from .recognizer import TextRecognizer, build_recognizer

__all__ = ['FLAGSHIP_INPUT', 'TINY_INPUT', 'nrtr_tps_pp_cfg',
           'TextRecognizer', 'build_recognizer']
