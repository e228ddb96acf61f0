"""Loss blocks.

Counterpart of ``mxnet_tpu/gluon/loss.py``: every loss there.  Each loss
is a block ``loss(pred, label, [sample_weight])`` that returns one value
per example (the mean over every axis but ``batch_axis``), weighted by
``weight`` and ``sample_weight``; ``PoissonNLLLoss`` returns the mean over
everything, as there, and ``CTCLoss`` one loss a sequence.  Where the JAX
losses call an op that amp rewrites (``log``, ``exp``, ``sum``, ``mean``,
``log_softmax``), these call the port's registered op of that name, so
under ``amp.init`` a loss of fp16 or bf16 predictions computes in float32
there too.
"""
from __future__ import annotations

import math

import torch

from ..ops import core as C
from ..ops import nn as F
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "PoissonNLLLoss",
           "CosineEmbeddingLoss", "SDMLLoss", "CTCLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if label.shape != pred.shape else label


def _log1p_exp_neg_abs(x):
    """log(1 + exp(-|x|)), as the JAX package writes it."""
    return C.log(1.0 + C.exp(-torch.abs(x)))


class Loss(HybridBlock):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_nonbatch(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return C.mean(loss, axis=axes) if axes else loss

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (type(self).__name__,
                                            self._batch_axis, self._weight)


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(_reshape_like(pred, label) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_nonbatch(loss)


class L1Loss(Loss):
    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(_reshape_like(pred, label) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + \
                    _log1p_exp_neg_abs(pred)
            else:
                # (1-y)*x + (1 + (pw-1)*y) * (-log(sigmoid(x)))
                softplus_neg = _log1p_exp_neg_abs(pred) + torch.relu(-pred)
                log_weight = 1 + (pos_weight - 1) * label
                loss = (1 - label) * pred + log_weight * softplus_neg
        else:
            eps = 1e-12
            loss = -(C.log(pred + eps) * label
                     + C.log(1 - pred + eps) * (1 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis)
        else:
            loss = -C.sum(pred * _reshape_like(pred, label), axis=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (C.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class CTCLoss(Loss):
    """CTC loss (``ops.nn.ctc_loss``, blank class 0) a sequence:
    ``loss(pred, label, pred_lengths=None, label_lengths=None,
    sample_weight=None)``, pred in ``layout`` NTC or TNC, label in
    ``label_layout`` NT or TN."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        loss = F.ctc_loss(pred, label, pred_lengths, label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        err = torch.abs(_reshape_like(pred, label) - pred)
        loss = torch.where(err > self._rho, err - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(err))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * _reshape_like(pred, label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(torch.relu(
            self._margin - pred * _reshape_like(pred, label)))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _log1p_exp_neg_abs(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        loss = C.sum(torch.square(pred - positive)
                     - torch.square(pred - negative),
                     axis=tuple(range(1, pred.dim())))
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _reshape_like(pred, target)
        if self._from_logits:
            loss = C.exp(pred) - target * pred
        else:
            loss = pred - target * C.log(pred + epsilon)
        if self._compute_full:
            stirling = target * C.log(target + 1e-12) - target + \
                0.5 * C.log(2 * math.pi * (target + 1e-12))
            stirling = torch.where(target <= 1, torch.zeros_like(stirling),
                                   stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return C.mean(loss)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        cos = C.sum(input1 * input2, axis=-1) / (
            torch.sqrt(C.sum(torch.square(input1), axis=-1))
            * torch.sqrt(C.sum(torch.square(input2), axis=-1)) + 1e-12)
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1, 1 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed deep metric learning: softmax cross-entropy of the negative
    pairwise distances against a smoothed identity."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._sp = smoothing_parameter

    def forward(self, x1, x2):
        batch = x1.shape[0]
        d = torch.sqrt(C.sum(torch.square(x1.unsqueeze(1) - x2.unsqueeze(0)),
                             axis=-1) + 1e-12)
        eye = torch.eye(batch, dtype=x1.dtype, device=x1.device)
        labels = eye * (1 - self._sp - self._sp / (batch - 1)) + \
            self._sp / (batch - 1)
        return -C.sum(labels * F.log_softmax(-d, axis=-1), axis=-1)
