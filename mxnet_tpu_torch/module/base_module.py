"""BaseModule: the abstract training and inference interface, with the
``fit`` loop.

The counterpart of ``mxnet_tpu/module/base_module.py``: ``fit`` binds and
initializes from the iterator's shapes, then per epoch runs
``forward_backward``, ``update``, ``update_metric`` and the batch-end
callbacks over every batch (between a ``Monitor``'s ``tic`` and
``toc_print`` when one is given), logs the epoch's metric and time, hands
the parameters to the epoch-end callbacks and scores ``eval_data``.  It
tracks the training iterator, whose state the checkpoints written during
the fit record, and first restores a data state stashed by a checkpoint
loaded before it (:mod:`~mxnet_tpu_torch.io_resume`), so the first epoch
resumes at the next sample.  Telemetry, as the JAX loop's: each fetch is
a ``data.fetch`` span, each batch one ``telemetry.step_end`` record, and
with ``MXNET_TPU_BACKPRESSURE`` a backpressure controller ticks once a
batch.
"""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import io_resume
from .. import metric as metric_mod
from .. import telemetry
from .. import ndarray as nd
from ..context import cpu
from ..model import BatchEndParam
from ..initializer import Uniform

__all__ = ["BaseModule"]


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _batch_samples(batch, data_iter):
    """Samples a batch counts for throughput: the first data array's
    batch dim, less the declared pad."""
    try:
        n = int(batch.data[0].shape[0])
    except (AttributeError, IndexError, TypeError):
        n = int(getattr(data_iter, "batch_size", 0) or 0)
    pad = getattr(batch, "pad", None)
    if pad:
        n = max(0, n - int(pad))
    return n


def _check_input_names(symbol, names, typename, throw):
    """Every requested input name must be an argument of the symbol."""
    args = symbol.list_arguments()
    missing = [n for n in names if n not in args]
    if not missing:
        return
    suggestions = "\n\t".join(
        a for a in args if a not in symbol.list_auxiliary_states())
    for name in missing:
        msg = ("You created Module with Module(..., %s_names=%s) but input "
               "with name '%s' is not found in symbol.list_arguments(). "
               "Did you mean one of:\n\t%s"
               % (typename, names, name, suggestions))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule:
    """The base class of a module."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ----------------------------------------------------------- high level
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """``eval_metric`` over (up to ``num_batch`` batches of)
        ``eval_data`` by inference forwards; returns its name-value
        pairs."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        seen = 0
        for eval_batch in eval_data:
            if num_batch is not None and seen == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                info = BatchEndParam(epoch=epoch, nbatch=seen,
                                     eval_metric=eval_metric,
                                     locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(info)
            seen += 1
        if score_end_callback is not None:
            info = BatchEndParam(epoch=epoch, nbatch=seen,
                                 eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(info)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs without the batch's padding, nbatch, batch)``."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data``, without padding, on the host;
        ``merge_batches`` joins them along the batch axis."""
        per_batch = [[o.copyto(cpu()) for o in outs] for outs, _n, _b
                     in self.iter_predict(eval_data, num_batch=num_batch,
                                          reset=reset)]
        if not per_batch or not merge_batches:
            return per_batch
        counts = {len(outs) for outs in per_batch}
        if len(counts) != 1:
            raise ValueError("Cannot merge batches: mismatched output "
                             "counts %s" % counts)
        merged = [nd.array(np.concatenate([o.asnumpy() for o in outs]),
                           ctx=cpu())
                  for outs in zip(*per_batch)]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """Train for epochs ``begin_epoch`` to ``num_epoch``: bind and
        initialize from the iterator's shapes, then per batch
        ``forward_backward``, ``update``, ``update_metric`` and the
        batch-end callbacks; per epoch the log lines, the epoch-end
        callbacks with the current parameters, and the validation score."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        # the checkpoints of this run record train_data's state, and a
        # checkpoint loaded before this fit puts it back mid-epoch
        io_resume.track(train_data)
        io_resume.apply_pending(train_data)
        # MXNET_TPU_BACKPRESSURE: retune the prefetch depth on the ioview
        # verdict, a tick a batch
        backpressure = io_resume.maybe_controller(train_data)
        fetch_span = telemetry.span("data.fetch", category="io")

        for epoch in range(begin_epoch, num_epoch):
            started = time.time()
            eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            while True:
                # the fetch is a span of its own: a loop starved by the
                # input pipeline shows as data.fetch time
                with fetch_span:
                    batch = next(data_iter, None)
                if batch is None:
                    break
                step_t0 = time.perf_counter()
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(batch)
                self.update()
                self.update_metric(eval_metric, batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    info = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                         eval_metric=eval_metric,
                                         locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(info)
                telemetry.step_end(
                    samples=_batch_samples(batch, train_data),
                    step_time=time.perf_counter() - step_t0)
                if backpressure is not None:
                    backpressure.tick()
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - started)
            # the trained values off the device, for get_params() callers
            # and the epoch-end callbacks
            args, auxs = self.get_params()
            self.set_params(args, auxs)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, args, auxs)
            if eval_data:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)
            train_data.reset()

    # --------------------------------------------------------------- symbol
    @property
    def symbol(self):
        return self._symbol

    # ------------------------------------------------------------- abstract
    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        """The parameters as ``arg:``/``aux:`` names in a ``.params``
        file."""
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        save_dict = nd.load(fname, ctx=cpu())
        arg_params, aux_params = {}, {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()
