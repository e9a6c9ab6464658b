"""Imperative autograd: ``mx.autograd`` over torch's own autograd.

The counterpart of ``mxnet_tpu/autograd.py``.  The JAX package keeps a
tape of (op, attrs, inputs) and, in :func:`backward`, replays it as a pure
function of the marked variables under ``jax.vjp``.  Here the imperative
ops build torch's graph as they run: :func:`mark_variables` makes each
variable's tensor a leaf that requires a gradient, ``mx.nd.<op>`` runs with
grad mode on only while :func:`record` is active (under ``torch.no_grad()``
otherwise), and :func:`backward` asks torch for the gradients of the
outputs with respect to the marked leaves and writes them into the
variables' gradient arrays by ``grad_req``: ``'write'`` copies, ``'add'``
adds, ``'null'`` has none.  A variable that the outputs do not reach gets
zeros under ``'write'``, as in the JAX package.  Nothing is run twice, so
a hand-written kernel under ``record()`` launches once forward and once
backward.

Two differences follow from that design.  The forward runs once, in the
train mode of the ``record()`` it ran under, and each op's output node in
torch's graph keeps that mode (:func:`note_train_mode`).  The JAX package
replays its tape in ``backward``'s ``train_mode`` instead.  So here
``train_mode=None`` (the default) takes the gradients of the forward as it
ran, and a ``train_mode`` given that differs from the mode of an op the
outputs reach raises ``MXNetError`` rather than give the gradients of the
other mode.  And writes stay in place, the
port's mutable-NDArray contract, except under ``record()``: there an
in-place operator, ``arr[key] = v``, ``out=`` and the write-back of an
op's auxiliary states rebind the array to a new tensor, so a tensor the
recorded graph saved is never changed under it; a marked variable cannot
be written while recording.  A weight that ``nd.sgd_update(out=w)``
rewrites in place between two ``record()`` blocks is read afresh by the
next graph.
"""
from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager

import torch

from .base import MXNetError

__all__ = ["is_training", "is_recording", "set_is_training", "record",
           "train_section", "test_section", "pause", "mark_variables",
           "backward", "grad_and_loss", "note_train_mode"]

#: the key, in an autograd node's ``metadata``, of the train mode in which
#: the op that made the node ran
_MODE_KEY = "mxnet_train_mode"

_state = threading.local()


def _get(attr):
    return getattr(_state, attr, False)


def _marked():
    """id(NDArray) -> weak reference of every marked variable alive."""
    if not hasattr(_state, "marked"):
        _state.marked = weakref.WeakValueDictionary()
    return _state.marked


def is_training():
    return _get("train")


def is_recording():
    return _get("record")


def set_is_training(train_mode):
    """Set the train flag; returns the previous one."""
    prev = _get("train")
    _state.train = bool(train_mode)
    return prev


@contextmanager
def record(train_mode=True):
    """Record the imperative ops run inside (with ``train_mode`` as the
    ops' train flag: Dropout drops, BatchNorm uses batch statistics)."""
    prev_r, prev_t = _get("record"), _get("train")
    _state.record, _state.train = True, train_mode
    try:
        yield
    finally:
        _state.record, _state.train = prev_r, prev_t


train_section = record


@contextmanager
def test_section():
    """Record in inference mode."""
    with record(train_mode=False):
        yield


@contextmanager
def pause():
    """Stop recording inside, keeping the train flag."""
    prev_r, prev_t = _get("record"), _get("train")
    _state.record, _state.train = False, prev_t
    try:
        yield
    finally:
        _state.record, _state.train = prev_r, prev_t


def is_marked(arr):
    return _marked().get(id(arr)) is arr


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each variable a leaf of the graphs recorded from now on, with
    ``gradients[i]`` as its gradient array and ``grad_reqs`` (one or one
    per variable) ``'write'``, ``'add'`` or ``'null'``."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    marked = _marked()
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        t = v.data.detach()
        if req != "null" and t.is_floating_point():
            t.requires_grad_(True)
        v._data = t
        v._grad, v._grad_req = g, req
        marked[id(v)] = v


def note_train_mode(tensors, train):
    """Keep ``train``, the mode an op ran in under ``record()``, on the
    graph node of each of its outputs that has one."""
    for t in tensors:
        if t.grad_fn is not None:
            t.grad_fn.metadata[_MODE_KEY] = bool(train)


def recorded_modes(heads):
    """The train modes of the recorded ops that ``heads`` (tensors) reach
    through torch's graph."""
    modes, seen = set(), set()
    todo = [h.grad_fn for h in heads if h.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node in seen:
            continue
        seen.add(node)
        if _MODE_KEY in node.metadata:
            modes.add(node.metadata[_MODE_KEY])
        todo.extend(n for n, _i in node.next_functions if n is not None)
    return modes


def backward(outputs, out_grads=None, retain_graph=False, train_mode=None):
    """Gradients of ``outputs`` (head gradients ``out_grads``, else ones)
    into the gradient arrays of the marked variables.  ``retain_graph``
    keeps the graph for another backward.  The forward already ran, in its
    ``record()``'s train mode: ``train_mode=None`` takes it as it ran, and
    a ``train_mode`` that differs from the mode of an op the outputs reach
    raises (the JAX package would replay that op in ``train_mode``)."""
    from .ndarray import NDArray
    if isinstance(outputs, NDArray):
        outputs = [outputs]
    heads = [o.data for o in outputs]
    if out_grads is None:
        cots = [torch.ones_like(h) for h in heads]
    else:
        if not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        cots = [(g.data if isinstance(g, NDArray) else torch.as_tensor(g))
                .to(device=h.device, dtype=h.dtype)
                for g, h in zip(out_grads, heads)]
    pairs = [(h, c) for h, c in zip(heads, cots) if h.requires_grad]
    if not pairs:
        raise MXNetError("no operations recorded for backward: run the "
                         "outputs under autograd.record() on marked "
                         "variables")
    if train_mode is not None:
        other = recorded_modes([h for h, _c in pairs]) - {bool(train_mode)}
        if other:
            raise MXNetError(
                "backward(train_mode=%s) on outputs recorded in %s mode: "
                "the forward ran once, as recorded, and is not replayed; "
                "record it in the mode wanted, or leave train_mode None"
                % (bool(train_mode), "train" if other.pop() else
                   "inference"))
    variables = [v for v in list(_marked().values())
                 if v._grad_req != "null" and v.data.requires_grad]
    grads = torch.autograd.grad(
        [h for h, _c in pairs], [v.data for v in variables],
        [c for _h, c in pairs], retain_graph=retain_graph,
        allow_unused=True)
    with torch.no_grad():
        for v, g in zip(variables, grads):
            buf = v._grad.data
            if g is None:
                if v._grad_req == "write":
                    buf.zero_()
            elif v._grad_req == "add":
                buf.add_(g.to(buf.dtype))
            else:
                buf.copy_(g)


def grad_and_loss(func, argnum=None):
    """``func`` wrapped to return ``(gradients, outputs)``: the arguments
    (those at ``argnum``) marked with fresh zero gradients, ``func`` run
    under :func:`record` and its outputs differentiated."""
    def wrapped(*args):
        from .ndarray import zeros_like
        if argnum is None:
            variables = list(args)
        else:
            idx = argnum if isinstance(argnum, (list, tuple)) else [argnum]
            variables = [args[i] for i in idx]
        grads = [zeros_like(v) for v in variables]
        mark_variables(variables, grads)
        with record():
            outputs = func(*args)
        backward(outputs if isinstance(outputs, (list, tuple))
                 else [outputs])
        return grads, outputs
    return wrapped
