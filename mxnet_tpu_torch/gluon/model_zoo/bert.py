"""BERT: the encoder, the pretraining heads and the pretraining loss.

Counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py`` (``BERTModel``,
``BERTForPretraining``, ``pretraining_loss``, ``get_bert``,
``bert_12_768_12``), with the same parameter names.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops import nn as F
from .. import nn
from ..block import HybridBlock

__all__ = ["BERTModel", "BERTForPretraining", "pretraining_loss",
           "bert_12_768_12", "bert_24_1024_16", "get_bert"]


class BERTModel(HybridBlock):
    """BERT encoder: embeddings (word + position + token-type) -> LN ->
    dropout -> TransformerEncoder -> (sequence output, pooled output)."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 token_type_vocab_size=2, dropout=0.1, use_pooler=True,
                 layer_norm_eps=1e-12, **kwargs):
        super().__init__()
        self._units = units
        self.word_embed = nn.Embedding(vocab_size, units)
        self.token_type_embed = nn.Embedding(token_type_vocab_size, units)
        self.pos_embed = nn.PositionalEmbedding(max_length, units)
        self.embed_ln = nn.LayerNorm(epsilon=layer_norm_eps,
                                     in_channels=units)
        self.embed_dropout = nn.Dropout(dropout) if dropout else None
        self.encoder = nn.TransformerEncoder(
            num_layers, units, hidden_size, num_heads, dropout=dropout,
            attention_dropout=dropout, activation="gelu",
            layer_norm_eps=layer_norm_eps)
        self.pooler = (nn.Dense(units, activation="tanh", flatten=False,
                                in_units=units)
                       if use_pooler else None)

    def forward(self, inputs, token_types=None, valid_length=None):
        """inputs: (B, T) int token ids; token_types: (B, T);
        valid_length: (B,) unpadded lengths -> key-padding mask."""
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_ln(self.pos_embed(x))
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        mask = None
        if valid_length is not None:
            T = inputs.shape[1]
            steps = torch.arange(T, device=inputs.device)
            mask = steps.reshape(1, 1, 1, T) < \
                valid_length.reshape(-1, 1, 1, 1)
        seq = self.encoder(x, mask=mask)
        if self.pooler is None:
            return seq
        return seq, self.pooler(seq[:, 0, :])


class BERTForPretraining(HybridBlock):
    """MLM + NSP heads over BERTModel; returns (mlm_scores, nsp_scores).

    With ``tie_weights`` (the default) the MLM decoder is the word
    embedding, so ``bert.word_embed.weight`` takes gradient from both its
    uses; ``mlm_decoder`` exists only with ``tie_weights=False``."""

    def __init__(self, bert=None, vocab_size=30522, tie_weights=True,
                 layer_norm_eps=1e-12, **bert_kwargs):
        super().__init__()
        self.bert = bert if bert is not None else BERTModel(
            vocab_size=vocab_size, **bert_kwargs)
        if self.bert.pooler is None:
            raise MXNetError("BERTForPretraining needs the NSP pooled "
                             "output; build the backbone with "
                             "use_pooler=True")
        self._vocab_size = vocab_size
        self._tie = tie_weights
        units = self.bert._units
        self.mlm_transform = nn.Dense(units, activation="gelu",
                                      flatten=False, in_units=units)
        self.mlm_ln = nn.LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        if not tie_weights:
            self.mlm_decoder = nn.Dense(vocab_size, flatten=False,
                                        in_units=units)
        self.nsp_classifier = nn.Dense(2, flatten=False, in_units=units)

    def forward(self, inputs, token_types=None, valid_length=None,
                masked_positions=None):
        seq, pooled = self.bert(inputs, token_types, valid_length)
        h = seq
        if masked_positions is not None:
            # gather only the masked slots: (B, M, C)
            idx = masked_positions.long().unsqueeze(-1).expand(
                *masked_positions.shape, seq.shape[-1])
            h = F.take_along_axis(seq, idx, axis=1)
        h = self.mlm_ln(self.mlm_transform(h))
        if self._tie:
            emb = self.bert.word_embed.weight   # (V, C)
            mlm_scores = F.dot(h.reshape(-1, h.shape[-1]), emb.t()).reshape(
                *h.shape[:-1], self._vocab_size)
        else:
            mlm_scores = self.mlm_decoder(h)
        return mlm_scores, self.nsp_classifier(pooled)


def pretraining_loss(mlm_scores, nsp_scores, masked_labels, masked_weights,
                     nsp_labels):
    """Standard BERT pretraining loss: masked-LM cross entropy averaged
    over ``masked_weights`` plus the NSP cross entropy."""
    logp = F.log_softmax(mlm_scores, axis=-1)
    mlm_ll = F.pick(logp, masked_labels, axis=-1)
    denom = masked_weights.sum() + 1e-6
    mlm_loss = -(mlm_ll * masked_weights).sum() / denom
    nsp_logp = F.log_softmax(nsp_scores, axis=-1)
    nsp_loss = -F.pick(nsp_logp, nsp_labels, axis=-1).mean()
    return mlm_loss + nsp_loss


_BERT_CONFIGS = {
    "bert_12_768_12": dict(units=768, hidden_size=3072, num_layers=12,
                           num_heads=12),
    "bert_24_1024_16": dict(units=1024, hidden_size=4096, num_layers=24,
                            num_heads=16),
}


def get_bert(name, vocab_size=30522, pretraining=False, **kwargs):
    if name not in _BERT_CONFIGS:
        raise MXNetError("unknown bert config %r (have %s)"
                         % (name, sorted(_BERT_CONFIGS)))
    cfg = dict(_BERT_CONFIGS[name])
    cfg.update(kwargs)
    if pretraining:
        return BERTForPretraining(vocab_size=vocab_size, **cfg)
    return BERTModel(vocab_size=vocab_size, **cfg)


def bert_12_768_12(**kwargs):
    """BERT-base."""
    return get_bert("bert_12_768_12", **kwargs)


def bert_24_1024_16(**kwargs):
    """BERT-large."""
    return get_bert("bert_24_1024_16", **kwargs)
