"""Legacy CamelCase op names: MXNet 1.x's operator surface.

Counterpart of ``mxnet_tpu/ops/legacy.py``.  Where the snake_case op
already takes the 1.x attr names, the CamelCase name is a registry alias
(the same ``Operator``), and ``Activation`` is ``ops/nn.py``'s
``activation``; where the 1.x signature differs (``LeakyReLU``'s act_type
dispatch, ``Dropout``'s implicit training-mode generator, ``Embedding``'s
declarative attrs) a thin adapter maps it onto the port's op.  ``RNN``
unpacks its one parameter vector and runs ``gluon.rnn``'s fused
recurrence.

Not ported yet: ``ROIPooling`` (with detection).
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
        ("LRN", "lrn"), ("CTCLoss", "ctc_loss"),
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


def _rnn_num_outputs(attrs):
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


def RNN(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, lstm_state_clip_min=None,
        lstm_state_clip_max=None, **_ignored):
    """1.x fused RNN op: every layer's weights and biases in ONE flat
    vector (the weights of every (layer, direction) first, i2h then h2h,
    then all the biases likewise), data TNC, states (layers * dirs, B, H).
    The recurrence is ``gluon.rnn``'s fused one (cuDNN's RNN on the card),
    with dropout ``p`` between layers in training.  As in the JAX package,
    ``lstm_state_clip_*`` clips only the final cell state."""
    from ..gluon.rnn.rnn_layer import _GATES, rnn_forward

    I = data.shape[2]
    H = int(state_size)
    G = _GATES[mode]
    ndir = 2 if bidirectional else 1
    flat = parameters.reshape(-1).to(data.dtype)
    off, weights = 0, []
    for layer in range(int(num_layers)):
        in_sz = I if layer == 0 else H * ndir
        for _ in range(ndir):
            for shape in ((G * H, in_sz), (G * H, H)):
                n = shape[0] * shape[1]
                weights.append(flat[off:off + n].reshape(shape))
                off += n
    packed = []   # wi, wh, bi, bh for each (layer, direction)
    for k in range(int(num_layers) * ndir):
        packed += [weights[2 * k], weights[2 * k + 1],
                   flat[off:off + G * H], flat[off + G * H:off + 2 * G * H]]
        off += 2 * G * H
    c0 = state_cell if state_cell is not None else torch.zeros_like(state)
    drop = float(p) if p and _ag.is_training() else 0.0
    out, hT, cT = rnn_forward(
        mode, data, state, c0 if mode == "lstm" else None, packed,
        int(num_layers), bool(bidirectional), drop,
        generator=_random.generator(data.device) if drop else None)
    if mode == "lstm" and lstm_state_clip_min is not None:
        cT = cT.clamp(lstm_state_clip_min, lstm_state_clip_max)
    if not state_outputs:
        return out
    if mode == "lstm":
        return out, hT, cT
    return out, hT


register("RNN", num_outputs=_rnn_num_outputs)(RNN)


_ROI_POOL_CHUNK_BYTES = 256 << 20   # bound on one chunk's gathered maps


@register("ROIPooling")
def ROIPooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max-pool each RoI's bins, quantized to the feature grid: rois (R, 5)
    rows [batch_idx, x1, y1, x2, y2] in image coordinates, rounded after
    scaling; bin (i, j) covers rows [floor(y1 + i*bin_h), ceil(y1 +
    (i+1)*bin_h)) and the like for columns; an empty bin gives 0.  The
    RoIs' maps are gathered a chunk at a time, and each bin row reduced
    over the rows, then the columns."""
    ph, pw = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (pooled_size, pooled_size))
    N, C, H, W = data.shape
    R = rois.shape[0]
    dev, dt = data.device, data.dtype
    bidx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    # correctly rounded divisions (CUDA divides by a Python scalar through
    # its reciprocal, which can move a bin edge across an integer)
    bin_h = torch.clamp(y2 - y1 + 1.0, min=1.0) / torch.tensor(
        float(ph), device=dev)
    bin_w = torch.clamp(x2 - x1 + 1.0, min=1.0) / torch.tensor(
        float(pw), device=dev)

    def mask(lo, size, n, step):
        k = torch.arange(n, dtype=torch.float32, device=dev)
        start = torch.floor(lo[:, None] + k[None] * step[:, None])
        end = torch.ceil(lo[:, None] + (k[None] + 1.0) * step[:, None])
        pos = torch.arange(size, dtype=torch.float32, device=dev)
        return (pos >= start[..., None]) & (pos < end[..., None])

    hmask = mask(y1.float(), H, ph, bin_h.float())    # (R, ph, H)
    wmask = mask(x1.float(), W, pw, bin_w.float())    # (R, pw, W)
    neg = torch.tensor(-float("inf"), dtype=dt, device=dev)
    out = data.new_empty((R, C, ph, pw))
    chunk = max(1, _ROI_POOL_CHUNK_BYTES // max(1, C * H * W
                                                * data.element_size()))
    for lo in range(0, R, chunk):
        sel = slice(lo, lo + chunk)
        x = data[bidx[sel]]                          # (n, C, H, W)
        for i in range(ph):
            row = torch.where(hmask[sel, i][:, None, :, None], x, neg).amax(
                dim=2)                                # (n, C, W)
            out[sel, :, i] = torch.where(
                wmask[sel][:, None], row[:, :, None, :], neg).amax(dim=-1)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
