"""The optimizer update ops: ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``rmsprop_update`` and ``rmspropalex_update``.

The counterpart of ``mxnet_tpu/ops/optimizer_ops.py``.  Each rule is a pure
tensor function of the weight, the gradient and the states (``_sgd`` and
the rest) that returns the new weight and states in f32.  It is used two
ways:

* registered as an operator, as in the JAX package, so ``mx.sym.sgd_update``
  and Symbol JSON graphs that hold the ops run: the op's output is the new
  weight in its dtype, and the new states follow it as the ``mutate``
  updates, which ``mx.nd.<op>`` would write back;
* as the in-place functions of this module (``sgd_update(weight, grad,
  ..., out=None)``), which ``mx.nd.sgd_update`` and the ``Updater`` call:
  under ``torch.no_grad()`` they write the new states into the state
  tensors and the new weight into ``out`` (default: the weight).

The arithmetic is the JAX ops' in f32, term for term: the gradient
rescaled, clipped when ``clip_gradient > 0``, plus ``wd * weight``; Adam's
learning rate comes pre-scaled by its bias correction (``Optimizer`` does
that).  Each runs as a few elementwise PyTorch ops a parameter; a
multi-tensor update over all parameters is later work.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update"]


_COMMON = {"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0, "clip_gradient": -1.0}


def _prep_grad(grad, weight, rescale_grad, clip_gradient, wd):
    g = grad.float() * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g + wd * weight.float()


def _clip_weights(w, clip_weights):
    return w.clamp(-clip_weights, clip_weights) if clip_weights > 0 else w


def _sgd(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
         clip_gradient=-1.0):
    """w - lr * g."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    return (weight.float() - lr * g,)


def _sgd_mom(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
             rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * g; w + mom."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    new_mom = momentum * mom.float() - lr * g
    return weight.float() + new_mom, new_mom


def _adam(weight, grad, mean, var, lr=0.01, beta1=0.9, beta2=0.999,
          epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """mean and var by their decays; w - lr * mean / (sqrt(var) + eps),
    with no bias correction inside (the reference's fused op)."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    m = beta1 * mean.float() + (1 - beta1) * g
    v = beta2 * var.float() + (1 - beta2) * g.square()
    return weight.float() - lr * m / (v.sqrt() + epsilon), m, v


def _rmsprop(weight, grad, n, lr=0.01, gamma1=0.95, epsilon=1e-8, wd=0.0,
             rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    """n = (1 - gamma1) g^2 + gamma1 n; w - lr g / sqrt(n + eps)
    (Tieleman and Hinton)."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    new_n = (1 - gamma1) * g.square() + gamma1 * n.float()
    w = weight.float() - lr * g / (new_n + epsilon).sqrt()
    return _clip_weights(w, clip_weights), new_n


def _rmspropalex(weight, grad, n, g, delta, lr=0.01, gamma1=0.95,
                 gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0, clip_weights=-1.0):
    """The centered RMSProp of Graves (2013): n, g and delta; w + delta."""
    gr = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    new_n = (1 - gamma1) * gr.square() + gamma1 * n.float()
    new_g = (1 - gamma1) * gr + gamma1 * g.float()
    new_d = gamma2 * delta.float() - lr * gr / (
        new_n - new_g.square() + epsilon).sqrt()
    return (_clip_weights(weight.float() + new_d, clip_weights), new_n,
            new_g, new_d)


def _in_place(rule, name):
    """The in-place function of ``rule``: states and ``out`` (default: the
    weight) written under ``torch.no_grad()``."""
    @torch.no_grad()
    def fn(weight, grad, *states, out=None, **hyper):
        new = rule(weight, grad, *states, **hyper)
        for st, v in zip(states, new[1:]):
            st.copy_(v)
        (weight if out is None else out).copy_(new[0])
    fn.__name__ = name
    fn.__doc__ = rule.__doc__
    return fn


def _register(name, rule, states, params):
    @register(name, arg_names=("weight", "grad") + states,
              params={**_COMMON, **params}, mutate=states,
              doc=rule.__doc__)
    def op(attrs, ctx, weight, grad, *st):
        hyper = {k: float(attrs[k]) for k in _COMMON.keys() | params.keys()}
        new = rule(weight, grad, *st, **hyper)
        return (new[0].to(weight.dtype),) + tuple(
            v.to(s.dtype) for v, s in zip(new[1:], st))
    return _in_place(rule, name)


sgd_update = _register("sgd_update", _sgd, (), {})
sgd_mom_update = _register("sgd_mom_update", _sgd_mom, ("mom",),
                           {"momentum": 0.0})
adam_update = _register("adam_update", _adam, ("mean", "var"),
                        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
rmsprop_update = _register("rmsprop_update", _rmsprop, ("n",),
                           {"gamma1": 0.95, "epsilon": 1e-8,
                            "clip_weights": -1.0})
rmspropalex_update = _register(
    "rmspropalex_update", _rmspropalex, ("n", "g", "delta"),
    {"gamma1": 0.95, "gamma2": 0.9, "epsilon": 1e-8, "clip_weights": -1.0})
