"""NER: the BERT-softmax token classifier (counterpart of
``tps_pp_tpu/models/ner/bert.py``; the reference's
``ner/encoders/bert_encoder.py`` over its in-tree BERT
``ner/utils/bert.py``, ``ner/decoders/fc_decoder.py``,
``ner/classifiers/ner_classifier.py`` and
``ner/losses/masked_cross_entropy_loss.py``).

Post-norm BERT: word + position + type embeddings, LayerNorm (eps 1e-12),
dropout; per layer biased query / key / value projections with ``d_k =
hidden / heads``, the port's ``attend`` (float32 scores, masked keys at
the finite ``NEG_INF``, so that an all-padding row attends uniformly as in
JAX and gives no NaN), dropout on the probabilities, ``attention.output.
dense``, dropout, residual + LayerNorm, then the exact-erf GELU FFN,
dropout, residual + LayerNorm. Dropout sits at JAX's sites
(``bert.py:52-74`` and the head's at ``:88``), in train mode only, its
masks from the ``torch.Generator`` passed as ``rng``. Module names are
MMOCR 0.4.0's (``bert.embeddings``, ``bert.encoder.layer.{i}``,
``classifier``); there is no pooler, as in JAX. No hand-written kernel:
the post-norm, 768-wide, biased layers do not meet the encoder kernel's
contract (pre-norm, d_model 512), and the JAX package never routes BERT to
its Pallas encoder.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...registry import ENCODERS, HEADS, LOSSES
from ..transformer import attend, dropout


class _Embeddings(nn.Module):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings,
                 type_vocab_size):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings,
                                                hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size,
                                                  hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=1e-12)


class _SelfAttention(nn.Module):
    def __init__(self, hidden_size):
        super().__init__()
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)


class _DenseNorm(nn.Module):
    def __init__(self, d_in, d_out):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=1e-12)


class _Attention(nn.Module):
    def __init__(self, hidden_size):
        super().__init__()
        # ``self`` is the reference's name for the projections
        self.self = _SelfAttention(hidden_size)
        self.output = _DenseNorm(hidden_size, hidden_size)


class _Intermediate(nn.Module):
    def __init__(self, hidden_size, intermediate_size):
        super().__init__()
        self.dense = nn.Linear(hidden_size, intermediate_size)


class _Layer(nn.Module):
    def __init__(self, hidden_size, intermediate_size):
        super().__init__()
        self.attention = _Attention(hidden_size)
        self.intermediate = _Intermediate(hidden_size, intermediate_size)
        self.output = _DenseNorm(intermediate_size, hidden_size)


class _Stack(nn.Module):
    def __init__(self, n, hidden_size, intermediate_size):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(hidden_size, intermediate_size)
                                   for _ in range(n))


class _Bert(nn.Module):
    def __init__(self, vocab_size, hidden_size, num_hidden_layers,
                 intermediate_size, max_position_embeddings,
                 type_vocab_size):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, hidden_size,
                                      max_position_embeddings,
                                      type_vocab_size)
        self.encoder = _Stack(num_hidden_layers, hidden_size,
                              intermediate_size)


@ENCODERS.register_module()
class BertEncoder(nn.Module):
    """(input_ids (N, T), attention_mask (N, T) or None, token_type_ids or
    None) -> hidden states (N, T, hidden_size)."""

    def __init__(self, vocab_size: int = 21128, hidden_size: int = 768,
                 num_hidden_layers: int = 12, num_attention_heads: int = 12,
                 intermediate_size: int = 3072,
                 max_position_embeddings: int = 512,
                 type_vocab_size: int = 2, hidden_dropout_prob: float = 0.1,
                 attention_probs_dropout_prob: float = 0.1):
        super().__init__()
        self.hidden_size = hidden_size
        self.heads = num_attention_heads
        self.d_k = hidden_size // num_attention_heads
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.bert = _Bert(vocab_size, hidden_size, num_hidden_layers,
                          intermediate_size, max_position_embeddings,
                          type_vocab_size)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        N, T, _ = x.shape
        return x.reshape(N, T, self.heads, self.d_k).transpose(1, 2)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        N, T = input_ids.shape
        ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(ids)
        hidden = self.hidden_dropout_prob if self.training else 0.0
        probs = self.attention_probs_dropout_prob if self.training else 0.0
        emb = self.bert.embeddings
        pos = torch.arange(T, device=ids.device)[None].expand(N, T)
        x = (emb.word_embeddings(ids) + emb.position_embeddings(pos) +
             emb.token_type_embeddings(token_type_ids.long()))
        x = dropout(emb.LayerNorm(x), hidden, rng)
        mask = attention_mask[:, None, None, :]
        for layer in self.bert.encoder.layer:
            sa, out = layer.attention.self, layer.attention.output
            a = attend(self._split(sa.query(x)), self._split(sa.key(x)),
                       self._split(sa.value(x)), mask, self.d_k ** -0.5,
                       probs, rng)
            x = out.LayerNorm(x + dropout(out.dense(a), hidden, rng))
            h = F.gelu(layer.intermediate.dense(x))
            h = dropout(layer.output.dense(h), hidden, rng)
            x = layer.output.LayerNorm(x + h)
        return x


@HEADS.register_module()
class FCDecoder(nn.Module):
    """Dropout, then the per-token ``classifier`` (reference
    ``ner/decoders/fc_decoder.py``)."""

    def __init__(self, num_labels: int = 26, hidden_dropout_prob: float = 0.1,
                 hidden_size: int = 768):
        super().__init__()
        self.hidden_dropout_prob = hidden_dropout_prob
        self.classifier = nn.Linear(hidden_size, num_labels)

    def forward(self, hidden, rng: Optional[torch.Generator] = None):
        rate = self.hidden_dropout_prob if self.training else 0.0
        return self.classifier(dropout(hidden, rate, rng))


class NerClassifier(nn.Module):
    """``encoder`` + ``decoder`` (reference
    ``ner/classifiers/ner_classifier.py``): token ids -> per-token label
    logits (N, T, num_labels)."""

    def __init__(self, model_cfg: Dict):
        super().__init__()
        self.encoder = ENCODERS.build(model_cfg['encoder'])
        self.decoder = HEADS.build(model_cfg['decoder'],
                                   hidden_size=self.encoder.hidden_size)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decoder(self.encoder(input_ids, attention_mask,
                                         token_type_ids, rng), rng)


@LOSSES.register_module()
class MaskedCrossEntropyLoss:
    """Token-level cross entropy over the unmasked positions (reference
    ``ner/losses/masked_cross_entropy_loss.py``); a ``num_labels`` that is
    not the logits' width raises a ``ValueError``, as in JAX."""

    def __init__(self, num_labels=None, **kwargs):
        self.num_labels = num_labels

    def __call__(self, logits, labels, attention_mask
                 ) -> Dict[str, torch.Tensor]:
        C = logits.shape[-1]
        if self.num_labels is not None and C != self.num_labels:
            raise ValueError(
                f'loss num_labels={self.num_labels} != decoder logits '
                f'width {C} (check model.decoder.num_labels)')
        logp = torch.log_softmax(logits.float(), -1)
        tgt = labels.long().clamp(0, C - 1)
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        mask = attention_mask.float()
        return {'loss_cls': torch.sum(nll * mask) /
                torch.clamp(mask.sum(), min=1.0)}
