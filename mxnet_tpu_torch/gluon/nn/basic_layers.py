"""Basic layers: Dense, Dropout, BatchNorm (and SyncBatchNorm,
BatchNormReLU), LayerNorm, GroupNorm, InstanceNorm, RMSNorm, Embedding,
Flatten, Identity, Lambda/HybridLambda, Activation and the activation
layers (LeakyReLU, PReLU, ELU, SELU, GELU, SiLU, Swish, Mish),
Concatenate/HybridConcatenate, Sequential and HybridSequential.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``.  Parameter names
and layouts match (Dense weight (units, in_units), BatchNorm gamma, beta,
running_mean and running_var, LayerNorm/GroupNorm/InstanceNorm gamma and
beta, RMSNorm gamma, PReLU alpha, Embedding weight (input_dim,
output_dim)).  As in the JAX package, ``Swish`` is the later definition
there (``x * sigmoid(beta * x)``, not ``SiLU``), ``GELU`` defaults to the
exact erf form, and ``PReLU`` takes ``in_channels=1`` (its ``alpha`` is
not deferred).  Parameters are ``gluon.Parameter``s, created
zero-filled (LayerNorm gamma one) on the CPU; ``Block.initialize`` moves
and fills them, or weights come in through ``convert.load_jax_params``.
A size left 0 (``in_units``, ``in_channels``) is deferred: the layer's
first call infers it from the input (``_Resolving``).
"""
from __future__ import annotations

import math

import torch

from ... import autograd
from ... import random as _random
from ...base import MXNetError
from ...ops import nn as F
from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "SyncBatchNorm", "BatchNormReLU", "LayerNorm", "GroupNorm",
           "InstanceNorm", "RMSNorm", "Embedding", "Flatten", "Identity",
           "Lambda", "HybridLambda", "Activation", "LeakyReLU", "PReLU",
           "ELU", "SELU", "GELU", "SiLU", "Swish", "Mish", "Concatenate",
           "HybridConcatenate"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _param(shape, dtype="float32", fill=0.0, init=None, grad_req="write"):
    return Parameter(data=torch.full(tuple(shape), fill,
                                     dtype=_DTYPES[dtype]),
                     grad_req=grad_req, init=init)


class _Resolving(HybridBlock):
    """Leaf layer with parameters of deferred shape: the first call gives
    them the shapes ``infer_shape`` reads off the input, and fills them
    with the initializers ``initialize`` recorded."""

    def _resolve(self, *args):
        if any(0 in p.shape for p in self.parameters(recurse=False)):
            self.infer_shape(*args)

    def infer_shape(self, *args):
        raise NotImplementedError


class Sequential(Block):
    """Stack of blocks; children are named "0", "1", ...  ``len``,
    indexing and iteration reach the children; a slice is a new block of
    the same type holding them."""

    def __init__(self, *blocks):
        super().__init__()
        self.add(*blocks)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        vals = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)()
            net.add(*vals[key])
            return net
        return vals[key]


class HybridSequential(Sequential, HybridBlock):
    """A ``Sequential`` of hybrid blocks."""


class Dense(_Resolving):
    """Fully-connected layer, weight layout (units, in_units)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = _param((units, in_units), dtype,
                             init=weight_initializer)
        self.bias = (_param((units,), dtype, init=bias_initializer)
                     if use_bias else None)

    def infer_shape(self, x, *args):
        in_units = (math.prod(x.shape[1:]) if self._flatten
                    else x.shape[-1])
        self.weight._finish_deferred_init((self._units, in_units))

    def forward(self, x):
        self._resolve(x)
        out = F.fully_connected(x, self.weight, self.bias,
                                num_hidden=self._units,
                                flatten=self._flatten,
                                no_bias=self.bias is None)
        if self._activation:
            out = F.activation(out, act_type=self._activation)
        return out


class Dropout(HybridBlock):
    """Drops while ``autograd.is_training()`` (inside ``record()``), with a
    mask from the port's generator of x's device; identity otherwise."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__()
        if axes:
            raise MXNetError("Dropout(axes=...) is not ported")
        self._rate = rate

    def forward(self, x):
        if not autograd.is_training() or self._rate <= 0.0:
            return x
        return F.dropout(x, self._rate, _random.generator(x.device))


class BatchNorm(_Resolving):
    """Batch normalisation over ``axis`` (channels).  ``running_mean`` and
    ``running_var`` are parameters with ``grad_req='null'``; a call in
    training mode (``autograd.is_training()``, and not
    ``use_global_stats``) normalises with the batch's statistics and
    writes the updated running ones back in place, outside autograd
    (``ops.nn.batch_norm``).  ``center=False`` / ``scale=False`` freeze
    beta / gamma, and ``scale=False`` normalises with gamma fixed at
    one."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        shape = (in_channels,)
        self.gamma = _param(shape, fill=1.0, init=gamma_initializer,
                            grad_req="write" if scale else "null")
        self.beta = _param(shape, init=beta_initializer,
                           grad_req="write" if center else "null")
        self.running_mean = _param(shape, init=running_mean_initializer,
                                   grad_req="null")
        self.running_var = _param(shape, fill=1.0,
                                  init=running_variance_initializer,
                                  grad_req="null")

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p._finish_deferred_init((c,))

    def forward(self, x):
        self._resolve(x)
        training = autograd.is_training() and not self._use_global_stats
        out, new_mean, new_var = F.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._eps, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training and not autograd.is_recomputing():
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return out


class SyncBatchNorm(BatchNorm):
    """Cross-device batch norm; on one device it is ``BatchNorm``."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)


class BatchNormReLU(BatchNorm):
    """``BatchNorm`` followed by ReLU."""

    def forward(self, x):
        return torch.relu(super().forward(x))


class LayerNorm(_Resolving):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__()
        self._axis = axis
        self._eps = epsilon
        self.gamma = _param((in_channels,), fill=1.0,
                            init=gamma_initializer,
                            grad_req="write" if scale else "null")
        self.beta = _param((in_channels,), init=beta_initializer,
                           grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma._finish_deferred_init((c,))
        self.beta._finish_deferred_init((c,))

    def forward(self, x):
        self._resolve(x)
        return F.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                            eps=self._eps)


class Embedding(HybridBlock):
    """Lookup table of ``input_dim`` rows of ``output_dim``.  With
    ``sparse_grad`` the weight's gradient is ``row_sparse``
    (``grad_stype``): ``gluon.Trainer`` then hands a lazy-update optimizer
    only the rows a batch touched, and the others, with their optimizer
    state, stay as they were."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = _param((input_dim, output_dim), dtype,
                             init=weight_initializer)
        self.weight.grad_stype = "row_sparse" if sparse_grad else "default"

    def forward(self, x):
        return F.embedding(x, self.weight)


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return F.activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation(%s)" % self._act_type


class RMSNorm(_Resolving):
    """x / sqrt(mean(x^2) + eps) * gamma over ``axis``."""

    def __init__(self, axis=-1, epsilon=1e-6, in_channels=0, **kwargs):
        super().__init__()
        self._axis = axis
        self._eps = epsilon
        self.gamma = _param((in_channels,), fill=1.0, init="ones")

    def infer_shape(self, x, *args):
        self.gamma._finish_deferred_init((x.shape[self._axis],))

    def forward(self, x):
        self._resolve(x)
        return F.rms_norm(x, self.gamma, axis=self._axis, eps=self._eps)


class GroupNorm(_Resolving):
    """Normalisation over groups of channels (axis 1) and the spatial
    axes, then a per-channel gamma and beta."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__()
        self._num_groups = num_groups
        self._eps = epsilon
        self.gamma = _param((in_channels,), fill=1.0, init=gamma_initializer,
                            grad_req="write" if scale else "null")
        self.beta = _param((in_channels,), init=beta_initializer,
                           grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        self.gamma._finish_deferred_init((x.shape[1],))
        self.beta._finish_deferred_init((x.shape[1],))

    def forward(self, x):
        self._resolve(x)
        return F.group_norm(x, self.gamma, self.beta,
                            num_groups=self._num_groups, eps=self._eps)


class InstanceNorm(_Resolving):
    """Normalisation of each sample's channel over the spatial axes; as in
    the JAX package, ``center``/``scale`` leave gamma and beta learned."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__()
        self._eps = epsilon
        self.gamma = _param((in_channels,), fill=1.0, init=gamma_initializer)
        self.beta = _param((in_channels,), init=beta_initializer)

    def infer_shape(self, x, *args):
        self.gamma._finish_deferred_init((x.shape[1],))
        self.beta._finish_deferred_init((x.shape[1],))

    def forward(self, x):
        self._resolve(x)
        return F.instance_norm(x, self.gamma, self.beta, eps=self._eps)


class Identity(HybridBlock):
    def forward(self, x):
        return x


def _function(function):
    """A ``Lambda``'s callable: a name is the ``mx.nd`` function of that
    name, taken on tensors (a registry op's own function), as blocks run
    on tensors."""
    if not isinstance(function, str):
        return function
    from ... import ndarray as nd

    fn = getattr(nd, function)
    return getattr(fn, "fn", fn)


class Lambda(Block):
    """Wraps ``function`` (a callable, or the name of an ``mx.nd``
    function) as a block."""

    def __init__(self, function):
        super().__init__()
        self._func = _function(function)

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(Lambda, HybridBlock):
    """A ``Lambda`` of a hybridizable function."""


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01, **kwargs):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, slope=self._alpha)


class PReLU(_Resolving):
    """Leaky ReLU with a learned slope a channel (axis 1); ``alpha`` has
    ``in_channels`` entries (1 by default) from the first, initialised to
    0.25 unless ``alpha_initializer`` says otherwise."""

    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__()
        from ...initializer import Constant

        self.alpha = _param((in_channels,),
                            init=alpha_initializer or Constant(0.25))

    def forward(self, x):
        shape = [1] * x.dim()
        if x.dim() > 1:
            shape[1] = self.alpha.shape[0]
        return F.prelu(x, self.alpha.reshape(shape))


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, alpha=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return F.selu(x)


class GELU(HybridBlock):
    """GELU, the exact erf form unless ``approximation`` is not
    ``"erf"`` (then the tanh form)."""

    def __init__(self, approximation="erf", **kwargs):
        super().__init__()
        self._approx = approximation != "erf"

    def forward(self, x):
        return F.gelu(x, approximate=self._approx)


class SiLU(HybridBlock):
    def forward(self, x):
        return F.silu(x)


class Swish(HybridBlock):
    """x * sigmoid(beta * x)."""

    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)


class Mish(HybridBlock):
    def forward(self, x):
        return F.mish(x)


class Concatenate(Sequential):
    """Runs every child on the same input and concatenates their outputs
    along ``axis``."""

    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return torch.cat([block(x) for block in self._modules.values()],
                         dim=self._axis)


class HybridConcatenate(Concatenate, HybridBlock):
    """A ``Concatenate`` of hybrid blocks."""
