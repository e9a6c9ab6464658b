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
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier"]


class InitDesc(str):
    """A parameter name with its attributes (``__init__`` names a per-
    variable initializer, which is not yet ported)."""

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

    def __init__(self, rng=None):
        self.rng = _rng(rng)

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        if isinstance(desc, InitDesc) and desc.attrs.get("__init__"):
            raise MXNetError("per-variable __init__ initializers are not yet "
                             "ported to mxnet_tpu_torch")
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


class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


class Constant(Initializer):
    def __init__(self, value=0.0, rng=None):
        super().__init__(rng)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07, rng=None):
        super().__init__(rng)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = self.rng.uniform(-self.scale, self.scale, arr.shape)


class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01, rng=None):
        super().__init__(rng)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = self.rng.normal(0, self.sigma, arr.shape)


class Xavier(Initializer):
    """Xavier/Glorot: gaussian or uniform, scaled by the average, input or
    output fan (the reference's ``rnd_type`` x ``factor_type``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 rng=None):
        super().__init__(rng)
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

