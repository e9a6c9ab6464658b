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

``Load`` starts parameters from a ``.params`` dict (written by either
package), ``Mixed`` picks an initializer by name pattern, and ``FusedRNN``
initializes a ``FusedRNNCell``'s flat parameter vector gate by gate
through the cell's ``unpack_weights``/``pack_weights``.

A variable's ``__init__`` attribute (``sym.Variable(init=...)``, the
``dumps()`` string of an initializer, as the LSTM cell's ``LSTMBias``)
picks the initializer of that variable; it draws from the calling
initializer's generator, as the JAX package's draws all come from numpy's
global one.
"""
from __future__ import annotations

import json
import logging
import re

import numpy as np

from .base import MXNetError

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Load", "Mixed", "FusedRNN", "create", "register"]

_REGISTRY = {}


def register(klass):
    """Register an initializer class under its lower-case name, the name
    its ``dumps()`` string carries."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, rng=None, **kwargs):
    """An initializer from an instance, a name (with its constructor's
    ``kwargs``), or a ``dumps()`` string (``'["lstmbias", {"forget_bias":
    1.0}]'``); ``rng`` is passed to the one it makes when it draws."""
    if not isinstance(init, str):
        return init
    if init.startswith("["):
        name, kwargs = json.loads(init)
    else:
        name = init
    klass = _REGISTRY.get(name.lower())
    if klass is None:
        raise MXNetError("%s is not registered as an initializer" % name)
    if issubclass(klass, Initializer):
        kwargs = dict(kwargs, rng=rng)
    return klass(**kwargs)


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
        if name.endswith("upsampling"):
            _bilinear(arr)
        elif name.endswith("bias"):
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


def _bilinear(arr):
    """An upsampling kernel's bilinear weights (the reference's
    ``_init_bilinear``)."""
    shape = arr.shape
    weight = np.zeros(int(np.prod(shape)), dtype="float32")
    f = np.ceil(shape[3] / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    for i in range(int(np.prod(shape))):
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
    arr[:] = weight.reshape(shape)


def _host(v):
    """An NDArray, tensor or array as a numpy array."""
    if hasattr(v, "asnumpy"):
        return v.asnumpy()
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@register
class Load:
    """Parameters from a loaded dict (``nd.load`` of a ``.params`` file,
    ``arg:``/``aux:`` prefixes dropped), the others from ``default_init``;
    a shape that differs, or a missing name without a default, raises."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {
            (k[4:] if k.startswith(("arg:", "aux:")) else k): v
            for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError(
                    "Parameter %s cannot be initialized from loading, "
                    "shape mismatch %s vs %s" % (name, src.shape, arr.shape))
            arr[:] = _host(src)
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise MXNetError(
                    "Cannot Initialize %s. Not found in loaded param and no "
                    "default Initializer is provided." % name)
            self.default_init(name, arr)
            if self.verbose:
                logging.info("Initialized %s by default", name)


@register
class Mixed:
    """The initializer of the first regular expression in ``patterns`` that
    matches a parameter's name; no match raises."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must be same length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise MXNetError(
            "Parameter name %s did not match any pattern. Consider adding a "
            "\".*\" pattern at the end with default Initializer." % name)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


# the JAX package's aliases
_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


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
class Orthogonal(Initializer):
    """The orthogonal factor of a uniform (``rand_type="uniform"``) or
    normal draw of (out, in), times ``scale`` (Saxe et al., 2013)."""

    def __init__(self, scale=1.414, rand_type="uniform", rng=None):
        super().__init__(rng, scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = self.rng.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = self.rng.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * res).reshape(arr.shape)


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
class MSRAPrelu(Xavier):
    """He et al.'s initializer for PReLU nets: Xavier gaussian of magnitude
    ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25, rng=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         rng=rng)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling weights (a Deconvolution's kernel)."""

    def _init_weight(self, _, arr):
        _bilinear(arr)


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


@register
class FusedRNN(Initializer):
    """A ``FusedRNNCell``'s flat parameter vector, initialized per layer,
    direction and gate: unpacked by the cell's ``unpack_weights``, each
    piece given to ``init`` (an initializer, its ``dumps()`` string, or
    None for the descriptor's global initializer) under its unfused name,
    and packed back."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0, rng=None):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, rng=rng, **kwargs)
        super().__init__(rng, init=init.dumps() if init else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .rnn.rnn_cell import FusedRNNCell
        cell = FusedRNNCell(self._num_hidden, self._num_layers,
                            self._mode, self._bidirectional,
                            forget_bias=self._forget_bias)
        args = cell.unpack_weights({cell._parameter_name(): arr})
        # the pieces keep the vector's attributes but not its __init__,
        # which names this initializer (the JAX package passes it on and
        # recurses into the pieces)
        attrs = {k: v for k, v in getattr(desc, "attrs", {}).items()
                 if k != "__init__"}
        for name, a in args.items():
            desc_i = InitDesc(name, attrs)
            if self._init is None:
                if isinstance(desc, InitDesc) and desc.global_init:
                    desc.global_init(desc_i, a)
            else:
                self._init(desc_i, a)
        arr[:] = _host(cell.pack_weights(args)[cell._parameter_name()])
