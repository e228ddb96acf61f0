"""Training callbacks: ``Speedometer``, ``ProgressBar``, ``do_checkpoint``
(alias ``module_checkpoint``) and ``log_train_metric``.

Counterpart of ``mxnet_tpu/callback.py`` (reference python/mxnet/
callback.py): the batch- and epoch-end callbacks of estimator-style loops.
``do_checkpoint`` sends a Block to ``<prefix>-NNNN.params`` and a trainer
(``gluon.Trainer``, ``parallel.FusedTrainer``) to a checkpoint step under
``<prefix>-ckpt/``."""
from __future__ import annotations

import logging
import sys
import time

from .base import MXNetError

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint",
           "log_train_metric", "module_checkpoint"]


class Speedometer:
    """Log samples/sec (and metrics) every ``frequent`` batches
    [callback.py:131]."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s" % (
                param.epoch, count, speed,
                "\t".join("%s=%f" % kv for kv in name_value))
        else:
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec" % (
                param.epoch, count, speed)
        logging.info(msg)
        self.tic = time.time()


class ProgressBar:
    """Draw a text progress bar per batch [callback.py:185]."""

    def __init__(self, total, length=80):
        self.total = total
        self.bar_len = length

    def __call__(self, param):
        count = param.nbatch
        filled = int(round(self.bar_len * count / float(self.total)))
        pct = round(100.0 * count / float(self.total), 1)
        bar = "=" * filled + "-" * (self.bar_len - filled)
        sys.stdout.write("[%s] %s%%\r" % (bar, pct))
        sys.stdout.flush()


def do_checkpoint(prefix, period=1):
    """Epoch-end callback routing through ``mx.checkpoint``
    [callback.py:38].  Blocks keep the classic ``<prefix>-NNNN.params``
    file (now committed via the subsystem's atomic-file path, so a
    crash mid-save can't truncate the previous epoch); targets exposing
    ``save_checkpoint`` but not ``save_parameters`` — ``gluon.Trainer``,
    ``parallel.FusedTrainer`` — get a sharded, crash-consistent
    checkpoint step under ``<prefix>-ckpt/`` instead (params +
    optimizer state + step in one atomic unit)."""
    period = int(max(1, period))

    def _callback(epoch, sym=None, arg=None, aux=None):
        if (epoch + 1) % period != 0:
            return
        target = sym if sym is not None else arg
        if hasattr(target, "save_parameters"):
            fname = "%s-%04d.params" % (prefix, epoch + 1)
            target.save_parameters(fname)
        elif hasattr(target, "save_checkpoint"):
            # max_keep=None: keep every epoch, matching the historical
            # one-file-per-epoch behavior of the .params branch
            fname = target.save_checkpoint("%s-ckpt" % prefix,
                                           step=epoch + 1, max_keep=None)
        elif hasattr(target, "save"):
            fname = "%s-%04d.params" % (prefix, epoch + 1)
            target.save(fname)
        else:
            raise MXNetError(
                "do_checkpoint: %r has none of save_parameters/"
                "save_checkpoint/save — nothing was written"
                % (type(target).__name__,))
        logging.info("Saved checkpoint to \"%s\"", fname)

    return _callback


module_checkpoint = do_checkpoint


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging metrics every ``period`` [callback.py:86]."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            logging.info(
                "Iter[%d] Batch[%d] Train-%s", param.epoch, param.nbatch,
                "\t".join("%s=%f" % kv for kv in name_value))
            if auto_reset:
                param.eval_metric.reset()

    return _callback
