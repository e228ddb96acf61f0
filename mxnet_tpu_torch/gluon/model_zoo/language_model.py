"""Language models: the LSTM LM (``BASELINE.json`` config 5) and a
GPT-style decoder-only transformer LM.

Counterpart of ``mxnet_tpu/gluon/model_zoo/language_model.py``, with the
same children and parameter names.  The LSTM LM's recurrence is
``gluon.rnn``'s fused layer (cuDNN's RNN on the card); the transformer LM's
causal attention is ``ops.nn.multi_head_attention``, which sends long
sequences to the hand-written flash kernels.  A tied decoder is the
product with the embedding table (``ops.nn.dot``), as in the JAX package.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ops import nn as F
from .. import nn, rnn
from ..block import HybridBlock

__all__ = ["StandardRNNLM", "TransformerLM", "standard_lstm_lm_200",
           "standard_lstm_lm_650", "standard_lstm_lm_1500", "gpt_lm"]


def _tied_logits(x, embedding, vocab_size):
    """x (..., C) times the embedding table (V, C) transposed."""
    return F.dot(x.reshape(-1, x.shape[-1]), embedding.weight.t()) \
        .reshape(x.shape[:-1] + (vocab_size,))


class StandardRNNLM(HybridBlock):
    """Embedding -> (L)STM stack -> (tied) softmax decoder."""

    def __init__(self, vocab_size, embed_size=200, hidden_size=200,
                 num_layers=2, dropout=0.2, tie_weights=False, mode="lstm",
                 **kwargs):
        super().__init__()
        if tie_weights and embed_size != hidden_size:
            raise MXNetError("tied weights need embed_size == hidden_size")
        self._tie = tie_weights
        self._vocab_size = vocab_size
        self.embedding = nn.Embedding(vocab_size, embed_size)
        self.embed_dropout = nn.Dropout(dropout) if dropout else None
        rnn_cls = {"lstm": rnn.LSTM, "gru": rnn.GRU, "rnn": rnn.RNN}[mode]
        self.encoder = rnn_cls(hidden_size, num_layers=num_layers,
                               dropout=dropout, layout="NTC")
        self.out_dropout = nn.Dropout(dropout) if dropout else None
        if not tie_weights:
            self.decoder = nn.Dense(vocab_size, flatten=False)

    def forward(self, inputs, states=None):
        """inputs: (B, T) ids -> logits (B, T, V), or (logits, new
        states) when ``states`` are given."""
        x = self.embedding(inputs)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        if states is None:
            out = self.encoder(x)
        else:
            out, states = self.encoder(x, states)
        if self.out_dropout is not None:
            out = self.out_dropout(out)
        logits = (_tied_logits(out, self.embedding, self._vocab_size)
                  if self._tie else self.decoder(out))
        return logits if states is None else (logits, states)

    def begin_state(self, batch_size, **kwargs):
        return self.encoder.begin_state(batch_size, **kwargs)


class TransformerLM(HybridBlock):
    """Decoder-only (GPT-style) causal LM: pre-LN transformer cells with
    causal attention, a final LayerNorm and a (tied) decoder."""

    def __init__(self, vocab_size, units=256, hidden_size=1024,
                 num_layers=4, num_heads=8, max_length=1024, dropout=0.1,
                 tie_weights=True, **kwargs):
        super().__init__()
        self._tie = tie_weights
        self._vocab_size = vocab_size
        self.embedding = nn.Embedding(vocab_size, units)
        self.pos_embed = nn.PositionalEmbedding(max_length, units)
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(nn.TransformerEncoderCell(
                units, hidden_size, num_heads, dropout=dropout,
                pre_norm=True, causal=True))
        self.final_ln = nn.LayerNorm(in_channels=units)
        if not tie_weights:
            self.decoder = nn.Dense(vocab_size, flatten=False)

    def forward(self, inputs):
        x = self.pos_embed(self.embedding(inputs))
        if self.dropout is not None:
            x = self.dropout(x)
        for cell in self.layers:
            x = cell(x)
        x = self.final_ln(x)
        if self._tie:
            return _tied_logits(x, self.embedding, self._vocab_size)
        return self.decoder(x)


def standard_lstm_lm_200(vocab_size=33278, **kwargs):
    return StandardRNNLM(vocab_size, 200, 200, 2, dropout=0.2, **kwargs)


def standard_lstm_lm_650(vocab_size=33278, **kwargs):
    return StandardRNNLM(vocab_size, 650, 650, 2, dropout=0.5, **kwargs)


def standard_lstm_lm_1500(vocab_size=33278, **kwargs):
    return StandardRNNLM(vocab_size, 1500, 1500, 2, dropout=0.65, **kwargs)


def gpt_lm(vocab_size=50257, **kwargs):
    return TransformerLM(vocab_size, **kwargs)
