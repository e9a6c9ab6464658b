"""Training callbacks.

The counterpart of ``mxnet_tpu/callback.py``: the same names, signatures
and log lines, invoked by ``BaseModule.fit`` and ``model.FeedForward``
with a ``BatchEndParam`` (epoch, nbatch, eval_metric, locals).
"""
from __future__ import annotations

import logging
import math
import time

__all__ = ["Speedometer", "ProgressBar", "do_checkpoint", "module_checkpoint",
           "log_train_metric", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving a Module's state every ``period``
    epochs (role of reference callback.py module_checkpoint)."""
    every = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        done = iter_no + 1
        if done % every == 0:
            mod.save_checkpoint(prefix, done, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing ``prefix-symbol.json`` +
    ``prefix-%04d.params`` every ``period`` epochs (role of reference
    callback.py do_checkpoint)."""
    from .model import save_checkpoint
    every = max(1, int(period))

    def _callback(iter_no, sym, arg, aux):
        done = iter_no + 1
        if done % every == 0:
            save_checkpoint(prefix, done, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback printing the running training metric every
    ``period`` batches (role of reference log_train_metric)."""
    def _callback(param):
        metric = param.eval_metric
        if metric is None or param.nbatch % period != 0:
            return
        for name, value in metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            metric.reset()
    return _callback


class Speedometer:
    """Batch-end callback logging training throughput (samples/sec)
    every ``frequent`` batches, resetting the metric between reports
    (role of reference callback.py Speedometer)."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._mark = None          # (monotonic time, nbatch) of last report

    def __call__(self, param):
        now = time.monotonic()
        if self._mark is None or param.nbatch < self._mark[1]:
            # first batch of a run, or a new epoch rewound the counter
            self._mark = (now, param.nbatch)
            return
        if param.nbatch % self.frequent != 0:
            return
        elapsed = now - self._mark[0]
        batches = param.nbatch - self._mark[1]
        self._mark = (now, param.nbatch)
        if elapsed <= 0 or batches <= 0:
            return
        speed = batches * self.batch_size / elapsed
        metric = param.eval_metric
        if metric is not None:
            pairs = metric.get_name_value()
            metric.reset()
            for name, value in pairs:
                logging.info(
                    "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    "\tTrain-%s=%f",
                    param.epoch, param.nbatch, speed, name, value)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, speed)


class ProgressBar:
    """Batch-end callback drawing an ASCII progress bar over ``total``
    batches (role of reference callback.py ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        cells = int(round(self.bar_len * frac))
        logging.info("[%s] %s%%\r",
                     "=" * cells + "-" * (self.bar_len - cells),
                     math.ceil(100.0 * frac))


class LogValidationMetricsCallback:
    """Epoch-end callback printing every validation metric (role of
    reference callback.py LogValidationMetricsCallback)."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
