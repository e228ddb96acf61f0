"""BERT encoder of the serving slice.

Counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py`` (``BERTModel``,
``get_bert``, ``bert_12_768_12``), with the same parameter names.  The
pretraining heads and loss arrive with the training slice.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from .. import nn
from ..block import HybridBlock

__all__ = ["BERTModel", "bert_12_768_12", "get_bert"]


class BERTModel(HybridBlock):
    """BERT encoder: embeddings (word + position + token-type) -> LN ->
    dropout -> TransformerEncoder -> (sequence output, pooled output)."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 token_type_vocab_size=2, dropout=0.1, use_pooler=True,
                 layer_norm_eps=1e-12, **kwargs):
        super().__init__()
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


_BERT_CONFIGS = {
    "bert_12_768_12": dict(units=768, hidden_size=3072, num_layers=12,
                           num_heads=12),
}


def get_bert(name, vocab_size=30522, **kwargs):
    if name not in _BERT_CONFIGS:
        raise MXNetError("unknown bert config %r (have %s)"
                         % (name, sorted(_BERT_CONFIGS)))
    cfg = dict(_BERT_CONFIGS[name])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, **cfg)


def bert_12_768_12(**kwargs):
    """BERT-base."""
    return get_bert("bert_12_768_12", **kwargs)
