"""Recognition, detection, KIE and NER metrics (counterpart of
``tps_pp_tpu/evaluation``)."""
from .f1 import compute_f1_score, eval_ner_f1
from .ocr_metric import count_matches, eval_ocr_metric, levenshtein

__all__ = ['eval_ocr_metric', 'count_matches', 'levenshtein',
           'eval_hmean_iou', 'compute_f1_score', 'eval_ner_f1']


def __getattr__(name):
    # ``eval_hmean_iou`` lives beside DBNet's postprocessor, as in the JAX
    # package; imported on first use, since the models import this package
    if name == 'eval_hmean_iou':
        from ..models.textdet.postprocess import eval_hmean_iou
        return eval_hmean_iou
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
