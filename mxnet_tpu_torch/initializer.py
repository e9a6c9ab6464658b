"""Weight initializers.

The counterpart of ``mxnet_tpu/initializer.py``: an initializer is called
on ``(InitDesc or name, array)`` and dispatches on the name's suffix
(``weight``, ``bias``, ``gamma``, ``beta``, ``moving_*``), as the reference
does.  Arrays are numpy arrays on the host; the trainer moves them to the
device.

Random draws come from an explicit ``numpy.random.RandomState``: pass one
as ``rng``, or a seed (default 0) from which the initializer makes its own.
The JAX package draws from numpy's global generator instead; with the same
seed, and the same calls in the same order, the draws are equal, so a port
trainer built with ``seed=s`` starts from the weights a JAX trainer starts
from after ``np.random.seed(s)``.

A variable's ``__init__`` attribute (``sym.Variable(init=...)``, the
``dumps()`` string of an initializer, as the LSTM cell's ``LSTMBias``)
picks the initializer of that variable; it draws from the calling
initializer's generator, as the JAX package's draws all come from numpy's
global one.
"""
from __future__ import annotations

import json

import numpy as np

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "LSTMBias", "create"]

_REGISTRY = {}


def register(klass):
    """Register an initializer class under its lower-case name, the name
    its ``dumps()`` string carries."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, rng=None):
    """An initializer from an instance, a name, or a ``dumps()`` string
    (``'["lstmbias", {"forget_bias": 1.0}]'``); ``rng`` is passed to the
    one it makes."""
    if isinstance(init, Initializer):
        return init
    name, kwargs = json.loads(init) if init.startswith("[") else (init, {})
    klass = _REGISTRY.get(name.lower())
    if klass is None:
        raise MXNetError("%s is not registered as an initializer" % name)
    return klass(rng=rng, **kwargs)


class InitDesc(str):
    """A parameter name with its attributes (``__init__`` names the
    variable's own initializer)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _rng(rng):
    if isinstance(rng, np.random.RandomState):
        return rng
    return np.random.RandomState(0 if rng is None else int(rng))


class Initializer:
    """Base initializer; callable on ``(InitDesc or name, numpy array)``.
    ``rng`` is a ``RandomState`` or a seed for a new one."""

    def __init__(self, rng=None, **kwargs):
        self.rng = _rng(rng)
        self._kwargs = kwargs

    def dumps(self):
        """``[lower-case class name, constructor arguments]`` as JSON, the
        JAX package's string, which :func:`create` reads back."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        if isinstance(desc, InitDesc) and desc.attrs.get("__init__"):
            create(desc.attrs["__init__"], rng=self.rng)._init_weight(desc,
                                                                      arr)
            return
        name = desc.lower()
        if name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith(("moving_mean", "running_mean", "moving_inv_var",
                            "moving_avg")):
            arr[:] = 0.0
        elif name.endswith(("moving_var", "running_var")):
            arr[:] = 1.0
        else:
            raise MXNetError(
                "Unknown initialization pattern for %s. Default "
                "initialization is limited to \"weight\", \"bias\", "
                "\"gamma\" and \"beta\"" % desc)

    def _init_bias(self, _, arr):
        arr[:] = 0.0

    def _init_gamma(self, _, arr):
        arr[:] = 1.0

    def _init_beta(self, _, arr):
        arr[:] = 0.0

    def _init_weight(self, name, arr):
        raise NotImplementedError("must override _init_weight")


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0, rng=None):
        super().__init__(rng, value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07, rng=None):
        super().__init__(rng, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = self.rng.uniform(-self.scale, self.scale, arr.shape)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01, rng=None):
        super().__init__(rng, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = self.rng.normal(0, self.sigma, arr.shape)


@register
class Xavier(Initializer):
    """Xavier/Glorot: gaussian or uniform, scaled by the average, input or
    output fan (the reference's ``rnd_type`` x ``factor_type``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 rng=None):
        super().__init__(rng, rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError("Xavier initializer cannot be applied to vector "
                             "%s. It requires at least 2D." % name)
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[:] = self.rng.uniform(-scale, scale, arr.shape)
        elif self.rnd_type == "gaussian":
            arr[:] = self.rng.normal(0, scale, arr.shape)
        else:
            raise ValueError("Unknown random type")


@register
class LSTMBias(Initializer):
    """An LSTM's bias: zeros, with ``forget_bias`` on the forget gate's
    quarter (gate order i, f, g, o)."""

    def __init__(self, forget_bias=1.0, rng=None):
        super().__init__(rng, forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, _, arr):
        b = np.zeros(arr.shape, dtype="float32")
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = b
