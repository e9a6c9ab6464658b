"""Optimizers: the hyperparameter objects and their imperative updates.

The counterpart of ``mxnet_tpu/optimizer.py``: the ``create`` registry,
``rescale_grad``, ``clip_gradient``, ``lr_mult``/``wd_mult`` with the
reference's defaults (no weight decay unless the name ends in ``_weight``
or ``_gamma``), ``num_update``/``begin_num_update`` and an optional
``lr_scheduler``.  ``create_state``/``update`` are the Module path's: each
update runs the update ops of :mod:`.ops.optimizer_ops` (or, for NAG,
AdaGrad, AdaDelta, DCASGD, SGLD, Ftrl and Test, the JAX package's
arithmetic in PyTorch) in place on the weight's NDArray and its states,
one parameter at a time; SGLD's noise comes from the generator of the
weight's device (:func:`mxnet_tpu_torch.random.generator`), so its bits
differ from the JAX package's.  ``Updater``
keeps the states by index and pickles them in the JAX package's format.
``parallel.ShardedTrainer`` applies the same rules fused over its f32
masters (``parallel.trainer._make_update_rule``).
"""
from __future__ import annotations

import logging
import math
import pickle

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, zeros, array as _nd_array
from .ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "ccSGD", "NAG", "DCASGD", "SGLD", "Adam",
           "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Test", "Updater",
           "get_updater", "create", "register"]


def _variable_attrs(sym):
    """``{name: raw attrs}`` of a Symbol's variables."""
    return {n.name: n.raw_attr for n in sym._topo() if n.is_variable}


class Optimizer:
    """Base optimizer (reference ``python/mxnet/optimizer.py``)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise MXNetError("param_idx2name should be a dict of param "
                             "indexes to names")
        self.idx2name = param_idx2name.copy()
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    opt_registry = {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        if name in Optimizer.opt_registry:
            logging.warning("New optimizer %s.%s is overriding existing "
                            "optimizer %s", klass.__module__, klass.__name__,
                            name)
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym is not None:
            for name, attr in _variable_attrs(self.sym).items():
                if "__lr_mult__" in attr:
                    self.lr_mult[name] = float(attr["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            # reference: no decay on bias/beta (anything but weight/gamma)
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            for name, attr in _variable_attrs(self.sym).items():
                if "__wd_mult__" in attr:
                    self.wd_mult[name] = float(attr["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def create_state(self, index, weight):
        """The optimizer's state for one parameter (None: none)."""
        return None

    def update(self, index, weight, grad, state):
        """Update the NDArray ``weight`` in place from ``grad``."""
        raise NotImplementedError()

    # --------------------------------------------------------------- helpers
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _scaled_grad(self, grad):
        """grad * rescale_grad, clipped when ``clip_gradient`` is set (the
        NDArray-arithmetic optimizers' first lines)."""
        g = grad.data.float() * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g

    def _op_kwargs(self, lr, wd):
        kwargs = {"rescale_grad": self.rescale_grad, "lr": lr, "wd": wd}
        if self.clip_gradient:
            kwargs["clip_gradient"] = self.clip_gradient
        return kwargs


def _zeros_like(weight):
    return zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with optional momentum, through ``sgd_update`` or
    ``sgd_mom_update``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        kwargs = self._op_kwargs(lr, wd)
        if state is not None:
            _ops.sgd_mom_update(weight.data, grad.data, state.data,
                                momentum=self.momentum, **kwargs)
        else:
            _ops.sgd_update(weight.data, grad.data, **kwargs)


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        g = self._scaled_grad(grad)
        w = weight.data
        if state is not None:
            mom = state.data
            mom.copy_(mom * self.momentum)
            g = g + wd * w
            mom.copy_(mom + g)
            g = g + self.momentum * mom
            w.copy_(w - lr * g)
        else:
            w.copy_(w - lr * (g + wd * w))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: the gradient corrected by
    ``lamda * g * g * (w - w_previous)``, with optional momentum."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros_like(weight)
        return (mom, weight.copy())

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        g = self._scaled_grad(grad)
        mon, previous = state
        w, prev = weight.data, previous.data
        comp = g + wd * w + self.lamda * g * g * (w - prev)
        if mon is not None:
            mon.data.copy_(self.momentum * mon.data - lr * comp)
            step = mon.data
        else:
            step = -lr * comp
        prev.copy_(w)
        w.copy_(w + step)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: a half step of SGD plus
    N(0, lr) noise drawn from the weight's device generator."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        from .random import generator
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        g = self._scaled_grad(grad)
        w = weight.data
        noise = torch.normal(0.0, math.sqrt(lr), size=tuple(w.shape),
                             generator=generator(w.device), device=w.device,
                             dtype=w.dtype)
        w.copy_(w - lr / 2 * (g + wd * w) + noise)


@register
class ccSGD(SGD):
    """Deprecated alias of SGD, kept for compatibility."""


@register
class Adam(Optimizer):
    """Adam through ``adam_update``; the learning rate is scaled by the
    bias correction of the parameter's own update count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        _ops.adam_update(weight.data, grad.data, mean.data, var.data,
                         beta1=self.beta1, beta2=self.beta2,
                         epsilon=self.epsilon, **self._op_kwargs(lr, wd))


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, ctx=weight.context)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        g = self._scaled_grad(grad)
        history, w = state.data, weight.data
        history.copy_(history + g.square())
        w.copy_(w - lr * (g / (history + self.float_stable_eps).sqrt()
                          + wd * w))


@register
class RMSProp(Optimizer):
    """RMSProp: Tieleman and Hinton's through ``rmsprop_update``, or with
    ``centered=True`` the Graves (2013) variant through
    ``rmspropalex_update``.  The trainer's fused rules take the first
    only, as in the JAX package."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(zeros(weight.shape, ctx=weight.context)
                     for _ in range(n))

    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        kwargs = dict(self._op_kwargs(lr, wd), gamma1=self.gamma1,
                      epsilon=self.epsilon)
        if self.clip_weights:
            kwargs["clip_weights"] = self.clip_weights
        if not self.centered:
            (n,) = state
            _ops.rmsprop_update(weight.data, grad.data, n.data, **kwargs)
        else:
            n, g, delta = state
            _ops.rmspropalex_update(weight.data, grad.data, n.data, g.data,
                                    delta.data, gamma2=self.gamma2,
                                    **kwargs)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.context),
                zeros(weight.shape, ctx=weight.context))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        wd = self._get_wd(index)
        self._update_count(index)
        g = self._scaled_grad(grad)
        acc_g, acc_delta = (s.data for s in state)
        w = weight.data
        acc_g.copy_(self.rho * acc_g + (1.0 - self.rho) * g * g)
        delta = (acc_delta + self.epsilon).sqrt() \
            / (acc_g + self.epsilon).sqrt() * g
        acc_delta.copy_(self.rho * acc_delta
                        + (1.0 - self.rho) * delta * delta)
        w.copy_(w - delta - wd * w)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (FTRL-proximal) with an L1 term
    ``lamda1``: states ``dn`` and ``n``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (zeros(weight.shape, ctx=weight.context),   # dn
                zeros(weight.shape, ctx=weight.context))   # n

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        g = self._scaled_grad(grad)
        dn, n = (s.data for s in state)
        w = weight.data
        dn.copy_(dn + g - ((n + g * g).sqrt() - n.sqrt()) * w / lr)
        n.copy_(n + g * g)
        w.copy_((dn.sign() * self.lamda1 - dn)
                / ((self.beta + n.sqrt()) / lr + wd)
                * (dn.abs() > self.lamda1))


@register
class Test(Optimizer):
    """The reference's deterministic test optimizer: ``w += g *
    rescale_grad``, the state a copy of the new weight."""

    def create_state(self, index, weight):
        return zeros(weight.shape, ctx=weight.context)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight.data.copy_(weight.data + grad.data * self.rescale_grad)
        state.data.copy_(weight.data)


def _state_map(state, fn):
    """``fn`` over the NDArrays of a state (None, an NDArray or a tuple)."""
    if isinstance(state, tuple):
        return tuple(_state_map(s, fn) for s in state)
    if isinstance(state, NDArray):
        return fn(state)
    return state


class Updater:
    """The worker-side update closure of the Module path: ``updater(index,
    grad, weight)`` makes the index's state on first use and updates the
    weight in place.  ``get_states``/``set_states`` pickle ``{index: numpy
    array, tuple of them, or None}``, the JAX package's format, so a
    ``.states`` file loads in either package; restored states move to the
    weight's device at their first update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        state = self.states.get(index)
        if index not in self.states:
            state = self.optimizer.create_state(index, weight)
        else:
            ctx = weight.context
            state = _state_map(state, lambda s: s.as_in_context(ctx))
        self.states[index] = state
        self.optimizer.update(index, weight, grad, state)

    def set_states(self, states):
        def restore(v):
            if isinstance(v, tuple):
                return tuple(restore(x) for x in v)
            if isinstance(v, np.ndarray):
                return _nd_array(v, ctx=cpu())
            return v
        self.states = {k: restore(v)
                       for k, v in pickle.loads(states).items()}

    def get_states(self):
        return pickle.dumps({k: _state_map(v, NDArray.asnumpy)
                             for k, v in self.states.items()})


def get_updater(optimizer):
    return Updater(optimizer)
