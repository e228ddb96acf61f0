"""Transformer layers.

Counterpart of ``mxnet_tpu/gluon/nn/transformer.py`` (``MultiHeadAttention``,
``PositionwiseFFN``, ``TransformerEncoderCell``, ``TransformerEncoder``,
``PositionalEmbedding``, ``SinusoidalPositionalEmbedding``), with the same
children and parameter names.  The
attention core is ``ops.nn.multi_head_attention``: long sequences go to the
hand-written CUDA flash kernel.
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import random as _random
from ...base import MXNetError
from ...ops import nn as F
from ..block import HybridBlock
from .basic_layers import Dense, Dropout, Embedding, HybridSequential, \
    LayerNorm

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderCell", "TransformerEncoder",
           "PositionalEmbedding", "SinusoidalPositionalEmbedding"]


class MultiHeadAttention(HybridBlock):
    """Multi-head (self/cross) attention.

    forward(query, key=None, value=None, mask=None): key/value default to
    query.  ``mask`` broadcasts against (B, H, Tq, Tk).  ``dropout`` drops
    attention probabilities while ``autograd.is_training()``; long
    sequences take it inside the flash kernels.  Each call draws its
    dropout seed on the inputs' device (``random.draw_seed``), so a
    captured training step draws a fresh mask on every replay."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 causal=False, attention_impl="auto", in_units=0, **kwargs):
        super().__init__()
        if units % num_heads:
            raise MXNetError("units %d not divisible by num_heads %d"
                             % (units, num_heads))
        self._num_heads = num_heads
        self._causal = causal
        self._impl = attention_impl
        self._dropout = dropout
        in_units = in_units or units
        self.query_proj = Dense(units, use_bias=use_bias, flatten=False,
                                in_units=in_units)
        self.key_proj = Dense(units, use_bias=use_bias, flatten=False,
                              in_units=in_units)
        self.value_proj = Dense(units, use_bias=use_bias, flatten=False,
                                in_units=in_units)
        self.out_proj = Dense(units, use_bias=use_bias, flatten=False,
                              in_units=units)

    def forward(self, query, key=None, value=None, mask=None):
        key = query if key is None else key
        value = key if value is None else value
        drop = {}
        if self._dropout > 0.0 and autograd.is_training():
            drop = dict(attn_dropout=self._dropout,
                        dropout_seed=_random.draw_seed(query.device))
        out = F.multi_head_attention(
            self.query_proj(query), self.key_proj(key),
            self.value_proj(value), num_heads=self._num_heads, mask=mask,
            causal=self._causal, impl=self._impl, **drop)
        return self.out_proj(out)


class PositionwiseFFN(HybridBlock):
    """Transformer FFN: dense -> activation -> dense (+dropout)."""

    def __init__(self, units, hidden_size, activation="gelu", dropout=0.0,
                 use_bias=True, in_units=0, **kwargs):
        super().__init__()
        self.ffn_1 = Dense(hidden_size, use_bias=use_bias, flatten=False,
                           activation=activation, in_units=in_units or units)
        self.ffn_2 = Dense(units, use_bias=use_bias, flatten=False,
                           in_units=hidden_size)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.ffn_2(self.ffn_1(x))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class TransformerEncoderCell(HybridBlock):
    """Pre/post-LN encoder block: MHA + FFN with residuals."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 attention_dropout=0.0, activation="gelu", pre_norm=False,
                 layer_norm_eps=1e-12, causal=False, **kwargs):
        super().__init__()
        self._pre_norm = pre_norm
        self.attention = MultiHeadAttention(units, num_heads,
                                            dropout=attention_dropout,
                                            causal=causal, in_units=units)
        self.attn_ln = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.ffn = PositionwiseFFN(units, hidden_size, activation=activation,
                                   dropout=dropout, in_units=units)
        self.ffn_ln = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        if self._pre_norm:
            h = self.attention(self.attn_ln(x), mask=mask)
            x = x + (self.dropout(h) if self.dropout is not None else h)
            return x + self.ffn(self.ffn_ln(x))
        h = self.attention(x, mask=mask)
        if self.dropout is not None:
            h = self.dropout(h)
        x = self.attn_ln(x + h)
        return self.ffn_ln(x + self.ffn(x))


class TransformerEncoder(HybridBlock):
    """Stack of encoder cells."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, attention_dropout=0.0, activation="gelu",
                 pre_norm=False, layer_norm_eps=1e-12, causal=False,
                 **kwargs):
        super().__init__()
        self.layers = HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderCell(
                units, hidden_size, num_heads, dropout=dropout,
                attention_dropout=attention_dropout, activation=activation,
                pre_norm=pre_norm, layer_norm_eps=layer_norm_eps,
                causal=causal))

    def forward(self, x, mask=None):
        for cell in self.layers:
            x = cell(x, mask=mask)
        return x


class PositionalEmbedding(HybridBlock):
    """Learned positional embedding (BERT-style)."""

    def __init__(self, max_length, units, **kwargs):
        super().__init__()
        self.embed = Embedding(max_length, units)
        self._max_length = max_length

    def forward(self, x):
        """x: (B, T, C) token embeddings -> x + pos[:T]."""
        T = x.shape[1]
        if T > self._max_length:
            raise MXNetError(
                "sequence length %d exceeds max_length %d of the learned "
                "positional table" % (T, self._max_length))
        pos = torch.arange(T, device=x.device)
        return x + self.embed(pos).reshape(1, T, -1)


class SinusoidalPositionalEmbedding(HybridBlock):
    """Fixed sin/cos positional encoding (Vaswani et al.): x (B, T, C) +
    pe, pe[t, 2i] = sin(t / 10000^(2i/C)) and pe[t, 2i+1] the cos; an odd
    ``units`` has one cos column fewer than sin."""

    def __init__(self, units, **kwargs):
        super().__init__()
        self._units = units

    def forward(self, x):
        T, C = x.shape[1], self._units
        pos = torch.arange(T, dtype=torch.float32,
                           device=x.device)[:, None]
        dim = torch.arange(0, C, 2, dtype=torch.float32,
                           device=x.device)[None, :]
        angle = pos / torch.pow(10000.0, dim / C)
        pe = torch.zeros(T, C, dtype=x.dtype, device=x.device)
        pe[:, 0::2] = torch.sin(angle).to(x.dtype)
        pe[:, 1::2] = torch.cos(angle[:, :C // 2]).to(x.dtype)
        return x + pe[None]
