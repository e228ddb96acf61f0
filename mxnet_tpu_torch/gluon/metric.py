"""Evaluation metrics: ``EvalMetric`` and its registry, ``Accuracy``
through ``PCC``.

Counterpart of ``mxnet_tpu/gluon/metric.py``, computed on the host in
numpy as there: labels and predictions may be tensors (on any device,
in any float dtype) or arrays.
"""
from __future__ import annotations

import math

import numpy as _np

import torch

from ..base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "BinaryAccuracy", "MCC", "MAE", "MSE", "RMSE",
           "CrossEntropy", "Perplexity", "NegativeLogLikelihood",
           "PearsonCorrelation", "PCC", "Loss", "Torch", "Caffe",
           "CustomMetric", "create", "np"]

_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        out = CompositeEvalMetric()
        for m in metric:
            out.add(create(m))
        return out
    key = str(metric).lower()
    if key not in _METRIC_REGISTRY:
        raise MXNetError("unknown metric %r" % metric)
    return _METRIC_REGISTRY[key](*args, **kwargs)


def _to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.dtype != torch.float64:
            x = x.float()
        return x.cpu().numpy()
    return _np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _as_lists(labels, preds):
    if isinstance(labels, (torch.Tensor, _np.ndarray)):
        labels = [labels]
    if isinstance(preds, (torch.Tensor, _np.ndarray)):
        preds = [preds]
    return labels, preds


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label)
            pred = _to_np(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_np.int64).flatten()
            label = label.astype(_np.int64).flatten()
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__("%s_%d" % (name, top_k), **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).astype(_np.int64)
            pred = _to_np(pred)
            topk = _np.argsort(-pred, axis=-1)[..., :self.top_k]
            hit = (topk == label[..., None]).any(axis=-1)
            self.sum_metric += float(hit.sum())
            self.num_inst += hit.size


@register
class BinaryAccuracy(EvalMetric):
    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        super().__init__(name, **kwargs)
        self.threshold = threshold

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            pred = (_to_np(pred) > self.threshold).astype(_np.int64).flatten()
            label = _to_np(label).astype(_np.int64).flatten()
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


class _BinaryStats:
    def __init__(self):
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, label, pred):
        pred = pred.argmax(axis=-1) if pred.ndim > 1 else (pred > 0.5)
        pred = pred.astype(_np.int64).flatten()
        label = label.astype(_np.int64).flatten()
        self.tp += int(((pred == 1) & (label == 1)).sum())
        self.fp += int(((pred == 1) & (label == 0)).sum())
        self.tn += int(((pred == 0) & (label == 0)).sum())
        self.fn += int(((pred == 0) & (label == 1)).sum())

    @property
    def precision(self):
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0

    @property
    def recall(self):
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0

    @property
    def f1(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0

    @property
    def total(self):
        return self.tp + self.fp + self.tn + self.fn

    @property
    def mcc(self):
        denom = math.sqrt((self.tp + self.fp) * (self.tp + self.fn) *
                          (self.tn + self.fp) * (self.tn + self.fn))
        if denom == 0:
            return 0.0
        return (self.tp * self.tn - self.fp * self.fn) / denom


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.stats = _BinaryStats()

    def reset(self):
        self.stats = _BinaryStats()
        super().reset()

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            self.stats.update(_to_np(label), _to_np(pred))

    def get(self):
        return (self.name, self.stats.f1)


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)
        self.stats = _BinaryStats()

    def reset(self):
        self.stats = _BinaryStats()
        super().reset()

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            self.stats.update(_to_np(label), _to_np(pred))

    def get(self):
        return (self.name, self.stats.mcc)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _to_np(label), _to_np(pred)
            self.sum_metric += float(_np.abs(label - pred).mean()) * \
                label.shape[0]
            self.num_inst += label.shape[0]


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _to_np(label), _to_np(pred)
            self.sum_metric += float(((label - pred) ** 2).mean()) * \
                label.shape[0]
            self.num_inst += label.shape[0]


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).astype(_np.int64).flatten()
            pred = _to_np(pred).reshape(len(label), -1)
            prob = pred[_np.arange(len(label)), label]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += len(label)


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_np(label).astype(_np.int64).flatten()
            pred = _to_np(pred).reshape(len(label), -1)
            prob = pred[_np.arange(len(label)), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                prob = prob[~ignore]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += len(prob)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self._labels = []
        self._preds = []

    def reset(self):
        self._labels, self._preds = [], []
        super().reset()

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            self._labels.append(_to_np(label).flatten())
            self._preds.append(_to_np(pred).flatten())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return (self.name, float("nan"))
        l = _np.concatenate(self._labels)
        p = _np.concatenate(self._preds)
        return (self.name, float(_np.corrcoef(l, p)[0, 1]))


PCC = PearsonCorrelation


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        _, preds = _as_lists(_, preds)
        for pred in preds:
            pred = _to_np(pred)
            self.sum_metric += float(pred.sum())
            self.num_inst += pred.size


class Torch(Loss):
    def __init__(self, name="torch", **kwargs):
        super().__init__(name, **kwargs)


class Caffe(Loss):
    def __init__(self, name="caffe", **kwargs):
        super().__init__(name, **kwargs)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__("custom(%s)" % name, **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            val = self._feval(_to_np(label), _to_np(pred))
            if isinstance(val, tuple):
                s, n = val
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += val
                self.num_inst += 1


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", "feval")
    return CustomMetric(feval, name, allow_extra_outputs)


@register
class Fbeta(F1):
    """F-beta score (reference metric.py:815): weighted harmonic mean of
    precision/recall; beta > 1 favors recall."""

    def __init__(self, name="fbeta", beta=1, average="macro", **kwargs):
        super().__init__(name=name, average=average, **kwargs)
        self.beta = beta

    def get(self):
        p, r = self.stats.precision, self.stats.recall
        b2 = self.beta * self.beta
        denom = b2 * p + r
        return (self.name,
                (1 + b2) * p * r / denom if denom > 0 else 0.0)


@register
class MeanPairwiseDistance(EvalMetric):
    """Mean p-norm distance between pred and label vectors (reference
    metric.py:1197)."""

    def __init__(self, name="mpd", p=2, **kwargs):
        super().__init__(name, **kwargs)
        self.p = p

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            l_ = _to_np(label).reshape(_to_np(label).shape[0], -1)
            p_ = _to_np(pred).reshape(_to_np(pred).shape[0], -1)
            d = (_np.abs(p_ - l_) ** self.p).sum(axis=1) ** (1.0 / self.p)
            self.sum_metric += float(d.sum())
            self.num_inst += d.shape[0]


@register
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis (reference
    metric.py:1263)."""

    def __init__(self, name="cos_sim", eps=1e-12, **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            l_, p_ = _to_np(label), _to_np(pred)
            num = (l_ * p_).sum(axis=-1)
            den = _np.sqrt((l_ * l_).sum(axis=-1)) * \
                _np.sqrt((p_ * p_).sum(axis=-1))
            sim = num / _np.maximum(den, self.eps)
            self.sum_metric += float(sim.sum())
            self.num_inst += sim.size


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation coefficient over the confusion
    matrix (reference metric.py:1586 — the k-category generalization of
    MCC, Gorodkin 2004)."""

    def __init__(self, name="pcc", **kwargs):
        super().__init__(name, **kwargs)
        self._conf = None

    def reset(self):
        self._conf = None
        super().reset()

    def update(self, labels, preds):
        labels, preds = _as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            l_ = _to_np(label).astype(_np.int64).flatten()
            p_ = _to_np(pred)
            p_ = p_.argmax(axis=-1) if p_.ndim > 1 else (p_ > 0.5)
            p_ = p_.astype(_np.int64).flatten()
            k = int(max(l_.max(), p_.max())) + 1
            if self._conf is None:
                self._conf = _np.zeros((k, k), _np.float64)
            elif self._conf.shape[0] < k:
                grown = _np.zeros((k, k), _np.float64)
                grown[:self._conf.shape[0], :self._conf.shape[1]] = \
                    self._conf
                self._conf = grown
            for li, pi in zip(l_, p_):
                self._conf[pi, li] += 1
            self.num_inst += l_.shape[0]

    def get(self):
        if self._conf is None:
            return (self.name, 0.0)
        c = self._conf
        n = c.sum()
        t = c.sum(axis=1)  # predicted-class totals
        s = c.sum(axis=0)  # true-class totals
        cov_xy = c.trace() * n - (t * s).sum()
        cov_xx = n * n - (t * t).sum()
        cov_yy = n * n - (s * s).sum()
        denom = _np.sqrt(cov_xx * cov_yy)
        return (self.name, float(cov_xy / denom) if denom > 0 else 0.0)
