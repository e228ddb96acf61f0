"""Mixture-of-Experts layer.

Counterpart of ``mxnet_tpu/gluon/nn/moe.py``: top-k routed FFN experts
stacked on a leading dimension (``w1`` (E, in, hidden), ``b1`` (E,
hidden), ``w2`` (E, hidden, units), ``b2`` (E, units), ``gate`` (E,
in)), with the JAX package's dense-gather forward: every expert sees
every token and the top-k combine picks, with no capacity limit.  The
JAX parameters carry ``("ep", ...)`` sharding hints for expert
parallelism; the port builds them without hints (sharded parameters and
``parallel.moe_apply`` wait in ``ROADMAP.md`` Queue 1 item 7).  Equal
gate probabilities may pick other experts than the JAX package's
``top_k`` does (the two break ties differently).
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops import nn as F
from ..block import HybridBlock
from .basic_layers import _param

__all__ = ["MoE"]


class MoE(HybridBlock):
    """Top-k routed mixture of FFN experts.

    Parameters
    ----------
    num_experts : int
        Number of experts E.
    hidden_size : int
        Expert FFN hidden width.
    units : int
        Output width (and input width unless ``in_units`` given).
    top_k : int
        Experts per token.
    activation : str
        Expert hidden activation ('relu' or 'gelu', the tanh form).
    """

    def __init__(self, num_experts, hidden_size, units, top_k=2,
                 in_units=0, activation="relu", **kwargs):
        super().__init__()
        if top_k < 1 or top_k > num_experts:
            raise MXNetError("top_k must be in [1, num_experts]")
        if activation not in ("relu", "gelu"):
            raise MXNetError("unknown MoE activation %r" % (activation,))
        E = self._E = int(num_experts)
        self._hidden = int(hidden_size)
        self._units = int(units)
        self._k = int(top_k)
        self._act = activation
        in_units = int(in_units) or int(units)
        self.w1 = _param((E, in_units, self._hidden))
        self.b1 = _param((E, self._hidden), init="zeros")
        self.w2 = _param((E, self._hidden, self._units))
        self.b2 = _param((E, self._units), init="zeros")
        self.gate = _param((E, in_units))

    def forward(self, x):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        probs = torch.softmax(x2 @ self.gate.t(), dim=-1)
        top_vals, top_idx = torch.topk(probs, self._k, dim=-1)   # (T, k)
        norm = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
        h = torch.einsum("td,edh->eth", x2, self.w1) + self.b1[:, None]
        h = torch.relu(h) if self._act == "relu" else F.gelu(h)
        y_all = torch.einsum("eth,ehu->etu", h, self.w2) + self.b2[:, None]
        one_hot = torch.nn.functional.one_hot(top_idx, self._E).to(x2.dtype)
        combine = (one_hot * norm[..., None]).sum(1)                # (T, E)
        out = torch.einsum("te,etu->tu", combine, y_all)
        return out.reshape(tuple(lead) + (out.shape[-1],))

    def __repr__(self):
        return "MoE(experts=%d, hidden=%d, units=%d, top_k=%d)" % (
            self._E, self._hidden, self._units, self._k)
