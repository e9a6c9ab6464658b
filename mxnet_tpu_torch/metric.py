"""Evaluation metrics.

The counterpart of ``mxnet_tpu/metric.py``: every metric, ``create``,
``CompositeEvalMetric``, ``CustomMetric`` and ``np``.  ``update`` computes
on the predictions' own device and brings only each batch's sums to the
host: the GPT's probabilities at full width are a (16384, 16384) f32
array a batch, which a copy to the host per batch would make the slowest
part of the step.  Labels move to the predictions' device.  The values are
the JAX metrics' (their sums in f64 where the JAX code sums a numpy
array).  ``CustomMetric`` hands numpy arrays to its function, as the JAX
one does.  A non-finite batch value is counted in ``num_nonfinite`` and
left out of the average.
"""
from __future__ import annotations

import logging
import math

import numpy
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy", "Loss",
           "CustomMetric", "np", "create", "register"]


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(label_shape, pred_shape))


def _tensor(x):
    if isinstance(x, NDArray):
        return x.data.detach()
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(numpy.asarray(x))


def _pair(label, pred):
    """(label, pred) tensors on the prediction's device."""
    p = _tensor(pred)
    return _tensor(label).to(p.device), p


def _numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


class EvalMetric:
    """The base metric: ``sum_metric / num_inst`` (or one per output when
    ``num`` is given)."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num
        self.num_nonfinite = 0

    def update(self, labels, preds):
        raise NotImplementedError()

    def _accum(self, value, count=1):
        """Fold one batch's value into the running sum, unless it is not
        finite: that is counted and logged instead."""
        value = float(value)
        if not math.isfinite(value):
            self.num_nonfinite = getattr(self, "num_nonfinite", 0) + 1
            logging.getLogger(__name__).warning(
                "metric %r: dropping non-finite update value %r (%d so far)",
                self.name, value, self.num_nonfinite)
            return
        self.sum_metric += value
        self.num_inst += count

    def get(self):
        if self.num is None:
            if self.num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.sum_metric / self.num_inst)
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        values = [x / y if y != 0 else float("nan")
                  for x, y in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


_REGISTRY = {}


def register(klass, *aliases):
    """Register a metric class under its lower-cased name (and
    ``aliases``)."""
    for name in (klass.__name__.lower(),) + aliases:
        _REGISTRY[name] = klass
    return klass


def _alias(*aliases):
    def deco(klass):
        return register(klass, *aliases)
    return deco


def create(metric, num=None, **kwargs):
    """A metric from a name, a callable (a ``CustomMetric``), a metric
    (itself) or a list of them (a ``CompositeEvalMetric``)."""
    if callable(metric) and not isinstance(metric, type):
        return CustomMetric(metric, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, num, **kwargs))
        return composite
    if not isinstance(metric, str) or metric.lower() not in _REGISTRY:
        raise ValueError("Cannot find metric %r" % (metric,))
    klass = _REGISTRY[metric.lower()]
    if num is not None:
        try:
            return klass(num=num, **kwargs)
        except TypeError:
            pass
    return klass(**kwargs)


class CompositeEvalMetric(EvalMetric):
    """Several metrics as one."""

    def __init__(self, metrics=None, **kwargs):
        super().__init__("composite", **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError("Metric index {} is out of range 0 and {}"
                              .format(index, len(self.metrics)))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", ()):
            metric.reset()

    def get(self):
        names, results = [], []
        for metric in self.metrics:
            name, result = metric.get()
            names.extend([name] if isinstance(name, str) else name)
            results.extend(result if isinstance(result, list) else [result])
        return names, results


@_alias("acc")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy"):
        super().__init__(name)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab, p = _pair(label, pred)
            if p.shape != lab.shape:
                p = p.argmax(dim=self.axis)
            p = p.to(torch.int32).reshape(-1)
            lab = lab.to(torch.int32).reshape(-1)
            check_label_shapes(lab, p, shape=1)
            self.sum_metric += int((lab == p).sum().item())
            self.num_inst += lab.numel()


@_alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy"):
        super().__init__(name)
        self.top_k = top_k
        if self.top_k <= 1:
            raise MXNetError("Please use Accuracy if top_k is no more than 1")
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab, p = _pair(label, pred)
            order = torch.argsort(p.float(), dim=-1)
            lab = lab.to(torch.int64).reshape(-1)
            if order.dim() == 1:
                self.sum_metric += int((order == lab).sum().item())
            elif order.dim() == 2:
                classes = order.shape[1]
                top = order[:, classes - min(classes, self.top_k):]
                self.sum_metric += int((top == lab[:, None]).sum().item())
            self.num_inst += order.shape[0]


@register
class F1(EvalMetric):
    """Binary-classification F1."""

    def __init__(self, name="f1"):
        super().__init__(name)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab, p = _pair(label, pred)
            lab = lab.to(torch.int32)
            pred_label = p.argmax(dim=1)
            check_label_shapes(lab, p, shape=0)
            if torch.unique(lab).numel() > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            tp = int(((pred_label == 1) & (lab == 1)).sum().item())
            fp = int(((pred_label == 1) & (lab == 0)).sum().item())
            fn = int(((pred_label == 0) & (lab == 1)).sum().item())
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            f1 = 2 * precision * recall / (precision + recall) \
                if precision + recall > 0 else 0.0
            self._accum(f1)


@register
class Perplexity(EvalMetric):
    """exp(sum of -log p(label) / count) over every token seen; a label
    equal to ``ignore_label`` counts neither."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity"):
        super().__init__(name)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError("Perplexity: %d labels for %d predictions"
                             % (len(labels), len(preds)))
        loss, num = 0.0, 0
        for label, pred in zip(labels, preds):
            lab, p = _pair(label, pred)
            lab = lab.to(torch.int64).reshape(-1)
            p = p.reshape(-1, p.shape[self.axis])
            probs = p[torch.arange(lab.numel(), device=p.device), lab]
            if self.ignore_label is not None:
                ignore = lab == int(self.ignore_label)
                num -= int(ignore.sum().item())
                probs = torch.where(ignore, torch.ones_like(probs), probs)
            loss -= torch.log(probs.clamp(min=1e-10)).double().sum().item()
            num += lab.numel()
        self._accum(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(numpy.exp(self.sum_metric / self.num_inst)))


def _regression_pairs(labels, preds):
    check_label_shapes(labels, preds)
    for label, pred in zip(labels, preds):
        lab, p = _pair(label, pred)
        if lab.dim() == 1:
            lab = lab.reshape(lab.shape[0], 1)
        yield lab, p


@register
class MAE(EvalMetric):
    def __init__(self, name="mae"):
        super().__init__(name)

    def update(self, labels, preds):
        for lab, p in _regression_pairs(labels, preds):
            self._accum((lab - p).abs().double().mean().item())


@register
class MSE(EvalMetric):
    def __init__(self, name="mse"):
        super().__init__(name)

    def update(self, labels, preds):
        for lab, p in _regression_pairs(labels, preds):
            self._accum(((lab - p) ** 2.0).double().mean().item())


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse"):
        super().__init__(name)

    def update(self, labels, preds):
        for lab, p in _regression_pairs(labels, preds):
            self._accum(math.sqrt(((lab - p) ** 2.0).double().mean().item()))


@_alias("ce")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-8, name="cross-entropy"):
        super().__init__(name)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            lab, p = _pair(label, pred)
            lab = lab.reshape(-1)
            if lab.shape[0] != p.shape[0]:
                raise ValueError("CrossEntropy: %d labels for %d rows"
                                 % (lab.shape[0], p.shape[0]))
            prob = p[torch.arange(lab.shape[0], device=p.device),
                     lab.to(torch.int64)]
            self._accum((-torch.log(prob + self.eps)).double().sum().item(),
                        lab.shape[0])


@register
class Loss(EvalMetric):
    """The average of the raw outputs (for MakeLoss-style nets)."""

    def __init__(self, name="loss"):
        super().__init__(name)

    def update(self, _, preds):
        for pred in preds:
            p = _tensor(pred)
            self._accum(p.double().sum().item(), p.numel())


@register
class Torch(Loss):
    def __init__(self, name="torch"):
        super().__init__(name)


@register
class Caffe(Loss):
    def __init__(self, name="caffe"):
        super().__init__(name)


@register
class CustomMetric(EvalMetric):
    """A Python ``feval(label, pred)`` on numpy arrays, returning a value or
    ``(sum, count)``."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_numpy(label), _numpy(pred))
            if isinstance(reval, tuple):
                self._accum(*reval)
            else:
                self._accum(reval)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy ``feval`` into a :class:`CustomMetric`."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
