"""``mx.npx``: the numpy-extension ops of MXNet 2.0 (the "neural" ops used
with ``mx.np`` arrays) and the np-mode switches.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py``, with the same
names: each op is the port's registry op (``npx.softmax`` is
``nd.softmax``), so it runs through ``invoke`` and records on the tape,
and ``npx.multi_head_attention`` reaches the hand-written flash kernels
on the card as ``nd``'s does.
"""
from __future__ import annotations

from ..ndarray import (Activation, BatchNorm, Convolution, Deconvolution,
                       Embedding, FullyConnected, LayerNorm, Pooling,
                       dropout, one_hot, pick, relu, sigmoid, softmax,
                       log_softmax, topk, gamma, erf, erfinv,
                       sequence_mask, gather_nd, reshape, batch_dot,
                       leaky_relu, smooth_l1, group_norm, instance_norm,
                       rms_norm, l2_normalization, ctc_loss,
                       multi_head_attention, quantize, quantize_v2,
                       dequantize, requantize, sort, argsort,
                       take_along_axis, scatter_nd, sequence_last,
                       sequence_reverse, cast,
                       interleaved_matmul_selfatt_qk,
                       interleaved_matmul_selfatt_valatt,
                       interleaved_matmul_encdec_qk,
                       interleaved_matmul_encdec_valatt, div_sqrt_dim)
from ..ndarray.contrib import (foreach, while_loop, cond, isfinite, isnan,
                               isinf, arange_like, index_copy, index_array,
                               boolean_mask)
from ..operator import Custom  # noqa: F401  (npx.Custom)
from ..util import (is_np_array, is_np_shape, reset_np, set_np, use_np,
                    use_np_array, use_np_shape)
from ..base import MXNetError, get_env  # noqa: F401
from ..context import cpu, current_context, gpu, num_gpus
from .. import random  # noqa: F401
from ..ndarray import image  # noqa: F401  (npx.image op namespace)

fully_connected = FullyConnected
convolution = Convolution
pooling = Pooling
batch_norm = BatchNorm
layer_norm = LayerNorm
embedding = Embedding
activation = Activation


def num_tpus():
    """TPUs this process sees: none, in the port."""
    return 0


def tpu(device_id=0):
    raise MXNetError("the PyTorch port runs on CUDA cards: use "
                     "mx.gpu(%d) or mx.cpu()" % device_id)


def seed(s):
    random.seed(s)


def waitall():
    from ..ndarray.ndarray import waitall as _w

    return _w()


def load(fname):
    from .. import ndarray as nd

    return nd.load(fname)


def save(fname, data):
    from .. import ndarray as nd

    return nd.save(fname, data)
