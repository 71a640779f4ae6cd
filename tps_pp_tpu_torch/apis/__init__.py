from .abinet import ABINetRecognizer
from .detector import TextDetector, build_detector_module, init_detector
from .flagship import FLAGSHIP_INPUT, TINY_INPUT, nrtr_tps_pp_cfg
from .inference import init_recognizer, model_inference
from .ocr import MMOCR, TextRecInference
from .recognizer import TextRecognizer, build_recognizer
from .seg import SegRecognizer
from .test import eval_recognizer
from .train import train_recognizer

__all__ = ['ABINetRecognizer', 'SegRecognizer', 'FLAGSHIP_INPUT', 'TINY_INPUT',
           'nrtr_tps_pp_cfg', 'TextRecognizer', 'build_recognizer',
           'train_recognizer', 'init_recognizer', 'model_inference',
           'eval_recognizer', 'TextDetector', 'build_detector_module',
           'init_detector', 'MMOCR', 'TextRecInference']
