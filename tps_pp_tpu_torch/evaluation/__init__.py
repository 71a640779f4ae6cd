"""Recognition and detection metrics (counterpart of
``tps_pp_tpu/evaluation``, without its NER metric, which the port has no
model for yet)."""
from .ocr_metric import count_matches, eval_ocr_metric, levenshtein

__all__ = ['eval_ocr_metric', 'count_matches', 'levenshtein',
           'eval_hmean_iou']


def __getattr__(name):
    # ``eval_hmean_iou`` lives beside DBNet's postprocessor, as in the JAX
    # package; imported on first use, since the models import this package
    if name == 'eval_hmean_iou':
        from ..models.textdet.postprocess import eval_hmean_iou
        return eval_hmean_iou
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
