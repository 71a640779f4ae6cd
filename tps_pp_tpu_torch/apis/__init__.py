from .abinet import ABINetRecognizer
from .flagship import FLAGSHIP_INPUT, TINY_INPUT, nrtr_tps_pp_cfg
from .inference import init_recognizer, model_inference
from .recognizer import TextRecognizer, build_recognizer
from .seg import SegRecognizer
from .test import eval_recognizer
from .train import train_recognizer

__all__ = ['ABINetRecognizer', 'SegRecognizer', 'FLAGSHIP_INPUT', 'TINY_INPUT',
           'nrtr_tps_pp_cfg', 'TextRecognizer', 'build_recognizer',
           'train_recognizer', 'init_recognizer', 'model_inference',
           'eval_recognizer']
