"""The reference's ``contrib.autograd`` surface over
:mod:`mxnet_tpu_torch.autograd`, so scripts written against
``mx.contrib.autograd.train_section()`` run unchanged."""
from ..autograd import (is_training, set_is_training, train_section,
                        test_section, record, pause, mark_variables,
                        backward, grad_and_loss)

__all__ = ["is_training", "set_is_training", "train_section",
           "test_section", "mark_variables", "backward", "grad_and_loss",
           "compute_gradient", "grad"]


def compute_gradient(outputs):
    """Gradients of ``outputs`` into the marked variables' arrays."""
    backward(outputs)


def grad(func, argnum=None):
    """``func`` wrapped to return the gradients of its outputs with
    respect to its arguments (those at ``argnum``)."""
    grad_with_loss_func = grad_and_loss(func, argnum)

    def wrapped(*args):
        return grad_with_loss_func(*args)[0]
    return wrapped
