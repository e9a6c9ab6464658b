"""The optimizer update ops: ``sgd_update``, ``sgd_mom_update``,
``adam_update``, ``rmsprop_update`` and ``rmspropalex_update``.

The counterpart of ``mxnet_tpu/ops/optimizer_ops.py``.  The JAX ops are
pure functions that return the new weight and states, which the imperative
wrappers write back; here each is a plain tensor function under
``torch.no_grad()`` that writes the new states into the state tensors and
the new weight into ``out`` (default: the weight), in place.  The
arithmetic is the JAX ops' in f32, term for term: the gradient rescaled,
clipped when ``clip_gradient > 0``, plus ``wd * weight``; Adam's learning
rate comes pre-scaled by its bias correction (``Optimizer`` does that).
Each runs as a few elementwise PyTorch ops a parameter; a multi-tensor
update over all parameters is later work.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update"]


def _prep_grad(grad, weight, rescale_grad, clip_gradient, wd):
    g = grad.float() * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g + wd * weight.float()


def _write(out, weight, new_weight):
    (weight if out is None else out).copy_(new_weight)


def _clip_weights(w, clip_weights):
    return w.clamp(-clip_weights, clip_weights) if clip_weights > 0 else w


@torch.no_grad()
def sgd_update(weight, grad, out=None, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """w = w - lr * g."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    _write(out, weight, weight.float() - lr * g)


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, out=None, lr=0.01, momentum=0.0,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * g; w = w + mom."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    new_mom = momentum * mom.float() - lr * g
    mom.copy_(new_mom)
    _write(out, weight, weight.float() + new_mom)


@torch.no_grad()
def adam_update(weight, grad, mean, var, out=None, lr=0.01, beta1=0.9,
                beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    """mean and var by their decays; w = w - lr * mean / (sqrt(var) + eps),
    with no bias correction inside (the reference's fused op)."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    m = beta1 * mean.float() + (1 - beta1) * g
    v = beta2 * var.float() + (1 - beta2) * g.square()
    mean.copy_(m)
    var.copy_(v)
    _write(out, weight, weight.float() - lr * m / (v.sqrt() + epsilon))


@torch.no_grad()
def rmsprop_update(weight, grad, n, out=None, lr=0.01, gamma1=0.95,
                   epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """n = (1 - gamma1) g^2 + gamma1 n; w = w - lr g / sqrt(n + eps)
    (Tieleman and Hinton)."""
    g = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    new_n = (1 - gamma1) * g.square() + gamma1 * n.float()
    n.copy_(new_n)
    w = weight.float() - lr * g / (new_n + epsilon).sqrt()
    _write(out, weight, _clip_weights(w, clip_weights))


@torch.no_grad()
def rmspropalex_update(weight, grad, n, g, delta, out=None, lr=0.01,
                       gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0):
    """The centered RMSProp of Graves (2013): n, g and delta in place;
    w = w + delta."""
    gr = _prep_grad(grad, weight, rescale_grad, clip_gradient, wd)
    new_n = (1 - gamma1) * gr.square() + gamma1 * n.float()
    new_g = (1 - gamma1) * gr + gamma1 * g.float()
    new_d = gamma2 * delta.float() - lr * gr / (
        new_n - new_g.square() + epsilon).sqrt()
    n.copy_(new_n)
    g.copy_(new_g)
    delta.copy_(new_d)
    _write(out, weight, _clip_weights(weight.float() + new_d, clip_weights))
