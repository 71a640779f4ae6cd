"""Recognition metrics (counterpart of ``tps_pp_tpu/evaluation``, without
its detection and NER metrics, which the port has no model for yet)."""
from .ocr_metric import count_matches, eval_ocr_metric, levenshtein

__all__ = ['eval_ocr_metric', 'count_matches', 'levenshtein']
