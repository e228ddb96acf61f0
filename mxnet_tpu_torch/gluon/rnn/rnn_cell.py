"""Recurrent cells: one time step a call, and ``unroll`` over a sequence.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``, with the same cells,
children and parameter names (``i2h_weight`` (G*H, I), ``h2h_weight``,
``i2h_bias``, ``h2h_bias``; gates LSTM i, f, g, o and GRU r, z, n).  A
cell is ``cell(inputs, states) -> (output, new_states)`` on tensors (or
NDArrays, which come back as NDArrays); ``unroll`` is a Python loop over
the time axis on the tape, as the JAX package's eager path is.  The dropout
and zoneout masks come from the port's generator of the input's device and
act while ``autograd.is_training()``.
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import random as _random
from ...base import MXNetError
from ...ops import core as _core
from ...ops import nn as F
from ...ops import registry as _registry
from ..block import HybridBlock, _unwrap, _wrap
from ..nn.basic_layers import _Resolving, _param

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "HybridSequentialRNNCell",
           "VariationalDropoutCell"]


def _bernoulli(keep, like):
    """A 0/1 float mask shaped like ``like`` with P(1) = ``keep``."""
    return _random.draw(lambda: torch.bernoulli(
        torch.full_like(like, keep),
        generator=_random.generator(like.device)))


class RecurrentCell(HybridBlock):
    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states: tensors on the cell's device (the CPU for a cell
        with no parameters), or ``func(shape=..., **kwargs)`` for each
        (``mx.nd.zeros`` gives NDArrays)."""
        if func is not None:
            return [func(shape=info["shape"], **kwargs)
                    for info in self.state_info(batch_size)]
        p = next(self.parameters(), None)
        device = p.device if p is not None else torch.device("cpu")
        dtype = p.dtype if p is not None else torch.float32
        return [torch.zeros(info["shape"], dtype=dtype, device=device)
                for info in self.state_info(batch_size)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """The cell over ``length`` steps of ``inputs`` -> (outputs,
        states).  Outputs are stacked on the time axis unless
        ``merge_outputs`` is False (a list a step); with ``valid_length``
        they are stacked, and the steps at and past each sequence's length
        are zero.  The states are those after the last step."""
        NDArray = _registry.NDArray
        if NDArray is not None and isinstance(inputs, NDArray):
            return _wrap(self.unroll(
                length, inputs._data, _unwrap(begin_state, NDArray), layout,
                merge_outputs, _unwrap(valid_length, NDArray)), NDArray)
        axis = layout.find("T")
        states = begin_state if begin_state is not None else \
            self.begin_state(inputs.shape[layout.find("N")])
        outputs = []
        for t in range(length):
            out, states = self(inputs.select(axis, t), states)
            outputs.append(out)
        if valid_length is not None:
            stacked = _core.sequence_mask(torch.stack(outputs), valid_length,
                                          use_sequence_length=True, axis=0)
            outputs = stacked.transpose(0, 1) if axis == 1 else stacked
        elif merge_outputs is None or merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return outputs, states

    def _get_activation(self, x, activation):
        if callable(activation):
            return activation(x)
        return F.activation(x, act_type=activation)


class _BaseRNNCell(RecurrentCell, _Resolving):
    def __init__(self, hidden_size, num_gates, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32"):
        super().__init__()
        self._hidden_size = hidden_size
        self._ng = num_gates
        G = num_gates * hidden_size
        self.i2h_weight = _param((G, input_size), dtype,
                                 init=i2h_weight_initializer)
        self.h2h_weight = _param((G, hidden_size), dtype,
                                 init=h2h_weight_initializer)
        self.i2h_bias = _param((G,), dtype, init=i2h_bias_initializer)
        self.h2h_bias = _param((G,), dtype, init=h2h_bias_initializer)

    def infer_shape(self, x, *args):
        self.i2h_weight._finish_deferred_init(
            (self._ng * self._hidden_size, x.shape[-1]))

    def _gates(self, inputs, h):
        """(i2h, h2h): the input's and the hidden state's gate terms."""
        self._resolve(inputs)
        return (F.fully_connected(inputs, self.i2h_weight, self.i2h_bias,
                                  flatten=False),
                F.fully_connected(h, self.h2h_weight, self.h2h_bias,
                                  flatten=False))


class RNNCell(_BaseRNNCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, 1, input_size, **kwargs)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def forward(self, inputs, states):
        i2h, h2h = self._gates(inputs, states[0])
        out = self._get_activation(i2h + h2h, self._activation)
        return out, [out]


class LSTMCell(_BaseRNNCell):
    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 4, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}] * 2

    def forward(self, inputs, states):
        H = self._hidden_size
        i2h, h2h = self._gates(inputs, states[0])
        gates = i2h + h2h
        i = F.sigmoid(gates[..., :H])
        f = F.sigmoid(gates[..., H:2 * H])
        g = torch.tanh(gates[..., 2 * H:3 * H])
        o = F.sigmoid(gates[..., 3 * H:])
        c = f * states[1] + i * g
        h = o * torch.tanh(c)
        return h, [h, c]


class GRUCell(_BaseRNNCell):
    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 3, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def forward(self, inputs, states):
        H = self._hidden_size
        prev = states[0]
        i2h, h2h = self._gates(inputs, prev)
        r = F.sigmoid(i2h[..., :H] + h2h[..., :H])
        z = F.sigmoid(i2h[..., H:2 * H] + h2h[..., H:2 * H])
        n = torch.tanh(i2h[..., 2 * H:] + r * h2h[..., 2 * H:])
        h = (1 - z) * n + z * prev
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked in depth; the states are one list a cell."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return [info for cell in self._modules.values()
                for info in cell.state_info(batch_size)]

    def begin_state(self, batch_size=0, **kwargs):
        return [cell.begin_state(batch_size, **kwargs)
                for cell in self._modules.values()]

    def forward(self, inputs, states):
        next_states = []
        for cell, state in zip(self._modules.values(), states):
            inputs, new_state = cell(inputs, state)
            next_states.append(new_state)
        return inputs, next_states

    def __len__(self):
        return len(self._modules)


HybridSequentialRNNCell = SequentialRNNCell


class _ModifierCell(RecurrentCell):
    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)


class DropoutCell(RecurrentCell):
    """Dropout on the inputs (shared along ``axes``); no state."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = tuple(axes)

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self._rate > 0 and autograd.is_training():
            inputs = F.dropout(inputs, self._rate,
                               _random.generator(inputs.device),
                               self._axes or None)
        return inputs, states


class ZoneoutCell(_ModifierCell):
    """Zoneout on the base cell's output and states while training.  As
    in the JAX package, the states' keep mask and the mask of the previous
    states are two separate draws."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def forward(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        if autograd.is_training():
            if self._zo > 0:
                mask = _bernoulli(1 - self._zo, out)
                prev = self._prev_output if self._prev_output is not None \
                    else torch.zeros_like(out)
                out = mask * out + (1 - mask) * prev
            if self._zs > 0:
                next_states = [
                    _bernoulli(1 - self._zs, ns) * ns
                    + (1 - _bernoulli(1 - self._zs, ns)) * s
                    for ns, s in zip(next_states, states)]
        self._prev_output = out
        return out, next_states

    def reset(self):
        self._prev_output = None


class ResidualCell(_ModifierCell):
    def forward(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward in time, outputs
    concatenated on the last axis; only ``unroll`` runs it.  As in the
    JAX package, each cell starts from its own zero states
    (``begin_state`` is not read)."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return (self.l_cell.state_info(batch_size)
                + self.r_cell.state_info(batch_size))

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        NDArray = _registry.NDArray
        if NDArray is not None and isinstance(inputs, NDArray):
            return _wrap(self.unroll(
                length, inputs._data, None, layout, merge_outputs,
                _unwrap(valid_length, NDArray)), NDArray)
        axis = layout.find("T")

        def reverse(x):
            if valid_length is None:
                return x.flip(axis)
            return _core.sequence_reverse(
                x.transpose(0, axis), valid_length, True).transpose(0, axis)

        l_out, l_states = self.l_cell.unroll(length, inputs, None, layout,
                                             True, valid_length)
        r_out, r_states = self.r_cell.unroll(length, reverse(inputs), None,
                                             layout, True, valid_length)
        out = torch.cat([l_out, reverse(r_out)], dim=2)
        return out, l_states + r_states

    def forward(self, inputs, states):
        raise MXNetError("BidirectionalCell must be used with unroll()")


class VariationalDropoutCell(_ModifierCell):
    """Locked dropout: one mask a sequence for the inputs, the first
    state and the outputs each, drawn at the first step after ``reset()``
    and reused at every step (``unroll`` resets first)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._di = drop_inputs
        self._ds = drop_states
        self._do = drop_outputs
        self.reset()

    def reset(self):
        self._mask_i = self._mask_s = self._mask_o = None
        if hasattr(self.base_cell, "reset"):
            self.base_cell.reset()

    @staticmethod
    def _mask(p, arr):
        keep = 1.0 - p
        return _bernoulli(keep, arr) / keep

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        return super().unroll(length, inputs, begin_state, layout,
                              merge_outputs, valid_length)

    def forward(self, inputs, states):
        training = autograd.is_training()
        if training and self._di > 0:
            if self._mask_i is None or self._mask_i.shape != inputs.shape:
                self._mask_i = self._mask(self._di, inputs)
            inputs = inputs * self._mask_i
        if training and self._ds > 0 and states:
            if self._mask_s is None or \
                    self._mask_s.shape != states[0].shape:
                self._mask_s = self._mask(self._ds, states[0])
            states = [states[0] * self._mask_s] + list(states[1:])
        out, next_states = self.base_cell(inputs, states)
        if training and self._do > 0:
            if self._mask_o is None or self._mask_o.shape != out.shape:
                self._mask_o = self._mask(self._do, out)
            out = out * self._mask_o
        return out, next_states

    def __repr__(self):
        return "VariationalDropoutCell(%r)" % (self.base_cell,)
