"""Optimizers: the hyperparameter objects the trainer reads.

The counterpart of ``mxnet_tpu/optimizer.py``: the ``create`` registry,
``rescale_grad``, ``clip_gradient``, ``lr_mult``/``wd_mult`` with the
reference's defaults (no weight decay unless the name ends in ``_weight``
or ``_gamma``), ``num_update``/``begin_num_update`` and an optional
``lr_scheduler``.  The update arithmetic of each class lives in
``parallel.trainer._make_update_rule``, which applies it in place to the f32
masters.  The imperative ``update()`` and ``Updater`` of the Module path are
not yet ported and raise.
"""
from __future__ import annotations

import logging

from .base import MXNetError

__all__ = ["Optimizer", "SGD", "ccSGD", "NAG", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Updater", "get_updater", "create", "register"]


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
        raise MXNetError("the imperative optimizer interface is not yet "
                         "ported to mxnet_tpu_torch; train through "
                         "parallel.ShardedTrainer")

    def update(self, index, weight, grad, state):
        raise MXNetError("the imperative optimizer interface is not yet "
                         "ported to mxnet_tpu_torch; train through "
                         "parallel.ShardedTrainer")


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with optional momentum."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""


@register
class ccSGD(SGD):
    """Deprecated alias of SGD, kept for compatibility."""


@register
class Adam(Optimizer):
    """Adam; the learning rate is scaled by the bias correction."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps


@register
class RMSProp(Optimizer):
    """RMSProp (Tieleman/Hinton); ``centered=True`` (Graves 2013) has no
    trainer formulation, as in the JAX package."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon


class Updater:
    """The worker-side update closure of the Module path: not yet ported."""

    def __init__(self, optimizer):
        raise MXNetError("Updater is not yet ported to mxnet_tpu_torch; "
                         "train through parallel.ShardedTrainer")


def get_updater(optimizer):
    return Updater(optimizer)
