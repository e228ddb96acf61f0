"""Fused multi-layer RNN, LSTM and GRU layers.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``, with the same
parameters (``l{n}[_r]_{i2h,h2h}_{weight,bias}`` per layer and direction,
gates stacked along the first axis: LSTM i, f, g, o; GRU r, z, n, with r
applied to ``W_hn·h + b_hn``).  The JAX package leaves the recurrence to
XLA (a ``lax.scan`` with the input GEMM batched over time); here it is
PyTorch's fused recurrent op (``torch._VF.lstm``/``gru``/``rnn_tanh``/
``rnn_relu``, what ``torch.nn.LSTM`` calls), which runs cuDNN's RNN on the
card and ATen's own loop on the CPU.  The gate layouts of the two packages
agree, so the Gluon parameters are the op's weight list as they are.

On the card nothing falls back: an input cuDNN refuses (a dtype other than
float16/32/64, cuDNN switched off, an empty tensor) raises instead of
taking ATen's non-cuDNN loop.  Before a call on the card the layer makes
its parameters views of one buffer in cuDNN's layout (one buffer a layer
when it drops between layers), so cuDNN reads them in place; an update in
place keeps them so, and a parameter whose data was replaced is flattened
again at the next call.

Dropout between layers acts while ``autograd.is_training()``, with a mask
from the port's generator (``ops.nn.dropout``); cuDNN's own dropout is
never used, so a layer with ``dropout > 0`` calls the op one layer at a
time.  ``rnn_reference`` is the plain per-step recurrence, as the JAX
package's ``_layer_scan`` writes it: the tests and ``chip_smoke.py`` hold
the fused op against it.
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import random as _random
from ...base import MXNetError
from ...ops import nn as F
from ..nn.basic_layers import _Resolving, _param

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
_CUDNN_MODES = {"lstm": "LSTM", "gru": "GRU", "rnn_tanh": "RNN_TANH",
                "rnn_relu": "RNN_RELU"}


def _check_cudnn(x):
    """On the card, raise unless cuDNN's RNN takes ``x`` (ATen's test,
    ``cudnn_is_acceptable``): the fused op would otherwise run ATen's
    non-cuDNN loop without a word."""
    if x.is_cuda and not (torch.backends.cudnn.is_acceptable(x)
                          and x.numel()):
        raise MXNetError(
            "cuDNN's RNN refuses a %s input of shape %s on %s (cuDNN on: "
            "%s); the port runs no other recurrence on the card"
            % (x.dtype, tuple(x.shape), x.device,
               torch.backends.cudnn.enabled))


def _fused(mode, x, h0, c0, weights, num_layers, bidirectional):
    """One call of the fused op on TNC ``x`` -> (out, hT, cT); cT is None
    but for the LSTM.  ``train`` is set whenever a gradient will be asked
    for (cuDNN's backward needs the forward's reserve), not only while
    training."""
    _check_cudnn(x)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, h0, *weights))
    fn = getattr(torch._VF, mode)
    if mode == "lstm":
        return fn(x, (h0, c0), weights, True, num_layers, 0.0, train,
                  bidirectional, False)
    out, hT = fn(x, h0, weights, True, num_layers, 0.0, train,
                 bidirectional, False)
    return out, hT, None


def rnn_forward(mode, x, h0, c0, weights, num_layers, bidirectional,
                dropout=0.0, per_layer=False, generator=None):
    """The fused recurrence on TNC ``x`` -> (out, hT, cT).

    ``weights``: wi, wh, bi, bh for each (layer, direction) in order;
    ``h0``/``c0``: (num_layers * ndir, B, H) (``c0`` only for the LSTM).
    ``dropout`` > 0 drops between layers with a mask from ``generator``;
    the op then runs a layer at a time, as it does with ``per_layer``."""
    if not (dropout > 0.0 or per_layer):
        return _fused(mode, x, h0, c0, weights, num_layers, bidirectional)
    ndir = 2 if bidirectional else 1
    hs, cs = [], []
    for layer in range(num_layers):
        rows = slice(layer * ndir, (layer + 1) * ndir)
        ws = weights[layer * 4 * ndir:(layer + 1) * 4 * ndir]
        x, hT, cT = _fused(mode, x, h0[rows],
                           None if c0 is None else c0[rows], ws, 1,
                           bidirectional)
        hs.append(hT)
        cs.append(cT)
        if dropout > 0.0 and layer < num_layers - 1:
            x = F.dropout(x, dropout, generator)
    return x, torch.cat(hs), (torch.cat(cs) if mode == "lstm" else None)


def _layer_steps(mode, x, h, c, wi, wh, bi, bh):
    """One direction of one layer, step by step: x (T, B, I) ->
    (outputs (T, B, H), hT, cT)."""
    H = h.shape[-1]
    x_gates = torch.einsum("tbi,gi->tbg", x, wi) + bi
    outs = []
    for xg in x_gates:
        hg = h @ wh.t() + bh
        if mode == "gru":
            r = torch.sigmoid(xg[:, :H] + hg[:, :H])
            z = torch.sigmoid(xg[:, H:2 * H] + hg[:, H:2 * H])
            n = torch.tanh(xg[:, 2 * H:] + r * hg[:, 2 * H:])
            h = (1 - z) * n + z * h
            c = h
        elif mode == "lstm":
            g = xg + hg
            i = torch.sigmoid(g[:, :H])
            f = torch.sigmoid(g[:, H:2 * H])
            gg = torch.tanh(g[:, 2 * H:3 * H])
            o = torch.sigmoid(g[:, 3 * H:])
            c = f * c + i * gg
            h = o * torch.tanh(c)
        elif mode == "rnn_relu":
            h = torch.relu(xg + hg)
        elif mode == "rnn_tanh":
            h = torch.tanh(xg + hg)
        else:
            raise MXNetError("unknown RNN mode %r" % (mode,))
        outs.append(h)
    return torch.stack(outs), h, c


def rnn_reference(mode, x, h0, c0, weights, num_layers, bidirectional,
                  dropout=0.0, masks=()):
    """The plain per-step version of ``rnn_forward`` (the JAX package's
    ``_rnn_forward``/``_layer_scan``): the same arguments, and the 0/1
    inter-layer dropout ``masks`` the fused call drew (one per layer but
    the last; none without dropout), scaled by 1/(1-``dropout``)."""
    ndir = 2 if bidirectional else 1
    c0 = torch.zeros_like(h0) if c0 is None else c0
    hs, cs = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(ndir):
            li = layer * ndir + d
            wi, wh, bi, bh = weights[4 * li:4 * li + 4]
            xd = x if d == 0 else x.flip(0)
            o, hT, cT = _layer_steps(mode, xd, h0[li], c0[li], wi, wh, bi,
                                     bh)
            outs.append(o if d == 0 else o.flip(0))
            hs.append(hT)
            cs.append(cT)
        x = outs[0] if ndir == 1 else torch.cat(outs, -1)
        if dropout > 0.0 and layer < num_layers - 1:
            x = x * masks[layer] / (1.0 - dropout)
    return x, torch.stack(hs), (torch.stack(cs) if mode == "lstm"
                                else None)


class _RNNLayer(_Resolving):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, dtype="float32",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__()
        if layout not in ("TNC", "NTC"):
            raise MXNetError("layout must be TNC or NTC, got %r"
                             % (layout,))
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._gates = _GATES[mode]
        self._flat_ptrs = None   # the weights' addresses once flattened
        G = self._gates * hidden_size
        for layer in range(num_layers):
            for d in range(self._dir):
                sfx = self._suffix(layer, d)
                isz = input_size if layer == 0 else hidden_size * self._dir
                setattr(self, sfx + "_i2h_weight",
                        _param((G, isz or 0), dtype,
                               init=i2h_weight_initializer))
                setattr(self, sfx + "_h2h_weight",
                        _param((G, hidden_size), dtype,
                               init=h2h_weight_initializer))
                setattr(self, sfx + "_i2h_bias",
                        _param((G,), dtype, init=i2h_bias_initializer))
                setattr(self, sfx + "_h2h_bias",
                        _param((G,), dtype, init=h2h_bias_initializer))

    @staticmethod
    def _suffix(layer, d):
        return "l%d%s" % (layer, "_r" if d else "")

    def _weights(self):
        return [getattr(self, "%s_%s" % (self._suffix(layer, d), part))
                for layer in range(self._num_layers)
                for d in range(self._dir)
                for part in ("i2h_weight", "h2h_weight", "i2h_bias",
                             "h2h_bias")]

    def infer_shape(self, x, *args):
        G = self._gates * self._hidden_size
        for layer in range(self._num_layers):
            isz = x.shape[-1] if layer == 0 else \
                self._hidden_size * self._dir
            for d in range(self._dir):
                getattr(self, self._suffix(layer, d) + "_i2h_weight") \
                    ._finish_deferred_init((G, isz))

    def _flatten(self, weights):
        """Make ``weights`` views of cuDNN's flat buffer(s), unless they
        still are since the last call."""
        if tuple(w.data_ptr() for w in weights) == self._flat_ptrs:
            return
        import torch.backends.cudnn.rnn as cudnn_rnn

        mode = cudnn_rnn.get_cudnn_mode(_CUDNN_MODES[self._mode])
        per_layer = self._dropout > 0.0
        groups = range(self._num_layers) if per_layer else [None]
        n = 4 * self._dir
        with torch.no_grad():
            for layer in groups:
                ws = weights if layer is None else \
                    weights[layer * n:(layer + 1) * n]
                torch._cudnn_rnn_flatten_weight(
                    ws, 4, ws[0].shape[1], mode, self._hidden_size, 0,
                    1 if per_layer else self._num_layers, False,
                    self._dir == 2)
        self._flat_ptrs = tuple(w.data_ptr() for w in weights)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size,
                 self._hidden_size)
        return [{"shape": shape}] * (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states: tensors on the parameters' device, or
        ``func(shape=..., **kwargs)`` for each (``mx.nd.zeros`` gives
        NDArrays)."""
        if func is not None:
            return [func(shape=info["shape"], **kwargs)
                    for info in self.state_info(batch_size)]
        w = self.l0_h2h_weight
        return [torch.zeros(info["shape"], dtype=w.dtype, device=w.device)
                for info in self.state_info(batch_size)]

    def forward(self, inputs, states=None):
        x = inputs if self._layout == "TNC" else inputs.transpose(0, 1)
        self._resolve(x)
        weights = self._weights()
        if x.is_cuda:
            _check_cudnn(x)
            self._flatten(weights)
        return_states = states is not None
        if states is None:
            states = self.begin_state(x.shape[1])
        elif isinstance(states, torch.Tensor):
            states = [states]
        h0 = states[0]
        c0 = states[1] if self._mode == "lstm" else None
        drop = self._dropout if autograd.is_training() else 0.0
        out, hT, cT = rnn_forward(
            self._mode, x, h0, c0, weights, self._num_layers,
            self._dir == 2, drop, per_layer=self._dropout > 0.0,
            generator=_random.generator(x.device) if drop else None)
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if not return_states:
            return out
        return out, ([hT, cT] if self._mode == "lstm" else [hT])


class RNN(_RNNLayer):
    """Elman RNN, ``activation`` 'relu' or 'tanh'."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 input_size=0, **kwargs):
        super().__init__("rnn_" + activation, hidden_size, num_layers,
                         layout, dropout, bidirectional, input_size,
                         **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)
