"""Legacy CamelCase op names: MXNet 1.x's operator surface.

Counterpart of ``mxnet_tpu/ops/legacy.py``.  Where the snake_case op
already takes the 1.x attr names, the CamelCase name is a registry alias
(the same ``Operator``), and ``Activation`` is ``ops/nn.py``'s
``activation``; where the 1.x signature differs (``LeakyReLU``'s act_type
dispatch, ``Dropout``'s implicit training-mode generator, ``Embedding``'s
declarative attrs) a thin adapter maps it onto the port's op.

Not ported yet: ``RNN`` (with the recurrent layers), ``ROIPooling`` (with
detection) and the ``CTCLoss`` alias (with ``ctc_loss``).
"""
from __future__ import annotations

import torch

from .. import autograd as _ag
from .. import random as _random
from ..base import MXNetError
from . import nn
from .registry import alias, register

for _camel, _snake in [
        ("Cast", "cast"), ("Concat", "concat"), ("Flatten", "flatten"),
        ("Reshape", "reshape"), ("Pad", "pad"), ("SwapAxis", "swapaxes"),
        ("SliceChannel", "split"), ("UpSampling", "upsampling"),
        ("BatchNorm", "batch_norm"), ("LayerNorm", "layer_norm"),
        ("GroupNorm", "group_norm"), ("InstanceNorm", "instance_norm"),
        ("LRN", "lrn"),
        ("SequenceMask", "sequence_mask"), ("SequenceLast", "sequence_last"),
        ("SequenceReverse", "sequence_reverse"),
        ("FullyConnected", "fully_connected"),
        ("Convolution", "convolution"), ("Deconvolution", "deconvolution"),
        ("Pooling", "pooling"), ("slice_channel", "split"),
        ("elemwise_add", "add"), ("elemwise_sub", "subtract"),
        ("elemwise_mul", "multiply"), ("elemwise_div", "divide"),
        ("broadcast_add", "add"), ("broadcast_sub", "subtract"),
        ("broadcast_mul", "multiply"), ("broadcast_div", "divide")]:
    alias(_camel, _snake)


register("Activation")(nn.activation)


@register("LeakyReLU")
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334):
    """act_type dispatcher.  rrelu draws a slope per element in training
    (from the port's generator of data's device) and takes the middle
    slope otherwise."""
    if act_type == "leaky":
        return nn.leaky_relu(data, slope=slope)
    if act_type == "prelu":
        return nn.prelu(data, gamma)
    if act_type == "elu":
        return nn.elu(data, alpha=slope)
    if act_type == "selu":
        return nn.selu(data)
    if act_type == "gelu":
        return nn.gelu(data)
    if act_type == "rrelu":
        if _ag.is_training():
            u = torch.empty(data.shape, dtype=torch.float32,
                            device=data.device).uniform_(
                lower_bound, upper_bound,
                generator=_random.generator(data.device)).to(data.dtype)
            return torch.where(data >= 0, data, data * u)
        return nn.leaky_relu(data, slope=(lower_bound + upper_bound) / 2.0)
    raise MXNetError("LeakyReLU: unknown act_type %r" % (act_type,))


@register("Dropout")
def Dropout(data, p=0.5, mode="training", axes=None, cudnn_off=False):
    """1.x Dropout: the mask comes from the port's generator, and it acts
    in training (``autograd``'s flag) or with ``mode='always'``."""
    active = mode == "always" or (mode == "training" and _ag.is_training())
    if not active or p <= 0.0:
        return data
    return nn._dropout_op(data, None, p=p, axes=axes)


@register("Embedding")
def Embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """1.x Embedding: input_dim/output_dim are declarative; the lookup is
    the same gather."""
    return nn.embedding(data, weight)
