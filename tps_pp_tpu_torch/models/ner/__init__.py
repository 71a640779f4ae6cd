"""NER: the BERT-softmax classifier (counterpart of
``tps_pp_tpu/models/ner``)."""
from .bert import BertEncoder, FCDecoder, MaskedCrossEntropyLoss, NerClassifier

__all__ = ['BertEncoder', 'FCDecoder', 'NerClassifier',
           'MaskedCrossEntropyLoss']
