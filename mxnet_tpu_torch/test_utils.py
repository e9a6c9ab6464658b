"""Operator test harness: the counterpart of ``mxnet_tpu/test_utils.py``
(the reference's ``python/mxnet/test_utils.py``).

``assert_almost_equal``, ``check_numeric_gradient`` (an op's autograd
gradient against central differences), ``check_symbolic_forward`` and
``check_symbolic_backward`` (a bound Symbol's outputs and gradients against
expected arrays) and ``check_consistency`` (one Symbol bound on several
contexts or dtypes from the same parameters, every output and gradient
compared with the most precise executor's).  Every ``ctx=None`` means
:func:`default_context`: ``MXNET_TEST_DEVICE`` when it is set, else the
current context (the card unless a ``with mx.cpu():`` is open).
"""
from __future__ import annotations

import os

import numpy as np

from . import autograd
from . import ndarray as nd
from .context import Context, current_context

__all__ = ["default_context", "rand_ndarray", "same", "assert_almost_equal",
           "numeric_grad", "check_numeric_gradient",
           "check_symbolic_forward", "check_symbolic_backward",
           "check_consistency", "default_tols"]


def default_context():
    """``MXNET_TEST_DEVICE`` (``cpu``, ``gpu`` or ``gpu(1)``), else
    :func:`current_context` (``gpu(0)`` unless a ``with ctx:`` is open)."""
    dev = os.environ.get("MXNET_TEST_DEVICE")
    if not dev:
        return current_context()
    kind, _, rest = dev.partition("(")
    return Context(kind, int(rest.rstrip(")")) if rest else 0)


def rand_ndarray(shape, dtype="float32", scale=1.0, ctx=None):
    return nd.array((np.random.randn(*shape) * scale).astype(dtype),
                    ctx=ctx or default_context())


def same(a, b):
    return np.array_equal(a, b)


def _np(a):
    return a.asnumpy() if isinstance(a, nd.NDArray) else np.asarray(a)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-8, names=("a", "b")):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg="%s != %s" % names)


def numeric_grad_one(f, inputs, i, eps=1e-3):
    """Central differences of the scalar ``f(inputs)`` with respect to
    ``inputs[i]``, one element at a time (by index, so a non-contiguous
    array is perturbed in place)."""
    x = inputs[i]
    g = np.zeros_like(x, dtype=np.float64)
    for idx in np.ndindex(*x.shape):
        orig = x[idx]
        x[idx] = orig + eps
        fp = f(inputs)
        x[idx] = orig - eps
        fm = f(inputs)
        x[idx] = orig
        g[idx] = (fp - fm) / (2 * eps)
    return g


def numeric_grad(f, inputs, eps=1e-3):
    return [numeric_grad_one(f, inputs, i, eps) for i in range(len(inputs))]


def check_numeric_gradient(op_name, input_arrays, attrs=None, rtol=1e-2,
                           atol=1e-3, eps=1e-3, wrt=None, weighted=False,
                           ctx=None):
    """The op's autograd gradient of ``sum(out)`` (``sum(out * w)`` for
    fixed weights w in [0.5, 1.5) under ``weighted``, which normalizing
    ops need: their plain sum's gradient is 0) against central
    differences, for the inputs at ``wrt`` (default: all; leave out index
    inputs, which a step of ``eps`` does not move)."""
    attrs = attrs or {}
    ctx = ctx or default_context()
    inputs = [np.asarray(a, np.float64) for a in input_arrays]
    wrt = list(range(len(inputs))) if wrt is None else list(wrt)
    weights = {}

    def weight_for(shape):
        w = weights.get(tuple(shape))
        if w is None:
            w = weights[tuple(shape)] = np.random.RandomState(5).uniform(
                0.5, 1.5, shape)
        return w

    def first(out):
        return out[0] if isinstance(out, list) else out

    def f(xs):
        arrs = [nd.array(x.astype("float32"), ctx=ctx) for x in xs]
        with autograd.pause():
            out = first(nd.invoke(op_name, *arrs, **attrs))
        o = out.asnumpy().astype(np.float64)
        return float((o * weight_for(o.shape) if weighted else o).sum())

    expected = {i: numeric_grad_one(f, inputs, i, eps) for i in wrt}
    arrs = [nd.array(x.astype("float32"), ctx=ctx) for x in inputs]
    grads = [nd.zeros_like(a) for a in arrs]
    autograd.mark_variables(arrs, grads)
    with autograd.record():
        out = first(nd.invoke(op_name, *arrs, **attrs))
        if weighted:
            out = out * nd.array(weight_for(out.shape).astype("float32"),
                                 ctx=ctx)
        loss = out.sum()
    autograd.backward([loss])
    for i in wrt:
        np.testing.assert_allclose(
            grads[i].asnumpy(), expected[i], rtol=rtol, atol=atol,
            err_msg="gradient mismatch on input %d of %s" % (i, op_name))


def _bind(sym, location, aux_states, ctx, grad_req="null"):
    names = sym.list_arguments()
    if not isinstance(location, dict):
        location = dict(zip(names, location))
    args = {k: nd.array(np.asarray(v), ctx=ctx) for k, v in location.items()}
    aux = None
    if aux_states is not None:
        aux_names = sym.list_auxiliary_states()
        if not isinstance(aux_states, dict):
            aux_states = dict(zip(aux_names, aux_states))
        aux = {k: nd.array(np.asarray(v), ctx=ctx)
               for k, v in aux_states.items()}
    return sym.bind(ctx, args, grad_req=grad_req, aux_states=aux)


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=None,
                           aux_states=None, ctx=None):
    """``sym`` bound to the arrays ``location`` (a list in argument order
    or a dict) and run forward in inference: each output against
    ``expected`` (a list in output order or a dict).  Returns the
    outputs."""
    exe = _bind(sym, location, aux_states, ctx or default_context())
    outs = [o.asnumpy() for o in exe.forward(is_train=False)]
    if isinstance(expected, dict):
        expected = [expected[k] for k in sym.list_outputs()]
    for name, got, want in zip(sym.list_outputs(), outs, expected):
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=1e-20 if atol is None else atol,
                                   err_msg="forward mismatch in %s" % name)
    return outs


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None):
    """``sym`` bound to ``location``, run forward in training and backward
    with the head gradients ``out_grads``: the gradient of each argument
    named in ``expected`` (a dict, or a list in argument order) against
    it.  Returns the gradients by name."""
    ctx = ctx or default_context()
    exe = _bind(sym, location, aux_states, ctx, grad_req)
    exe.forward(is_train=True)
    exe.backward([nd.array(np.asarray(g), ctx=ctx) for g in out_grads])
    if not isinstance(expected, dict):
        expected = dict(zip(sym.list_arguments(), expected))
    grads = {k: v.asnumpy() for k, v in exe.grad_dict.items()
             if v is not None}
    for name, want in expected.items():
        np.testing.assert_allclose(grads[name], want, rtol=rtol,
                                   atol=1e-20 if atol is None else atol,
                                   err_msg="gradient mismatch in %s" % name)
    return grads


def default_tols():
    """Per-dtype tolerance of :func:`check_consistency` (the reference's
    table, with bfloat16)."""
    return {"float16": 1e-1, "bfloat16": 1e-1, "float32": 1e-3,
            "float64": 1e-5, "uint8": 0, "int32": 0}


def _precision(dtype):
    dt = np.dtype(dtype)
    return np.finfo(dt).nmant if dt.kind == "f" or dt.name == "bfloat16" \
        else 0


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True):
    """``sym`` bound under every entry of ``ctx_list`` (dicts of ``ctx``,
    the input shapes by name and an optional ``type_dict``) from the same
    parameters (normal draws times ``scale`` from a seed, unless given):
    the inference outputs, then the training outputs and gradients (each
    executor's outputs as its head gradients), compared with the most
    precise executor's within its dtype's tolerance t: each element's
    ``|got - want| / (1 + |want|)`` at most t (rtol = atol = t).  Returns
    the ground truth by name (``"grad:<arg>"`` for gradients) and, under
    ``"max_err"``, the largest of those readings over every comparison."""
    tol = default_tols() if tol is None else (
        {k: tol for k in default_tols()} if isinstance(tol, (int, float))
        else tol)
    exes = []
    for entry in ctx_list:
        kw = dict(entry)
        dev = kw.pop("ctx", None) or default_context()
        exes.append(sym.simple_bind(ctx=dev, grad_req=grad_req, **kw))
    arg_params = dict(arg_params or {})
    aux_params = dict(aux_params or {})
    rng = np.random.RandomState(0)
    for n, arr in exes[0].arg_dict.items():
        arg_params.setdefault(n, rng.normal(size=arr.shape, scale=scale))
    for n, arr in exes[0].aux_dict.items():
        aux_params.setdefault(n, np.zeros(arr.shape))
    for exe in exes:
        for n, arr in exe.arg_dict.items():
            arr[:] = np.asarray(arg_params[n]).astype(arr.dtype)
        for n, arr in exe.aux_dict.items():
            arr[:] = np.asarray(aux_params[n]).astype(arr.dtype)
    names = sym.list_outputs()
    for exe in exes:
        exe.forward(is_train=False)
    dtypes = [exe.outputs[0].dtype for exe in exes]
    best = int(np.argmax([_precision(dt) for dt in dtypes]))
    readings = [0.0]

    def compare(i, name, got, want, phase):
        t = tol.get(np.dtype(dtypes[i]).name, tol.get("float32", 1e-3))
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        if got.size:
            err = np.abs(got - want) / (1 + np.abs(want))
            # NaN on both sides agrees (as assert_allclose has it); NaN on
            # one side is the worst reading
            err[np.isnan(got) & np.isnan(want)] = 0
            readings.append(float(np.max(np.nan_to_num(err, nan=np.inf))))
        try:
            np.testing.assert_allclose(
                got, want, rtol=t, atol=t, err_msg="%s: ctx %d vs ctx %d "
                "at %s" % (phase, i, best, name))
        except AssertionError:
            if raise_on_err:
                raise

    truth = {n: o.asnumpy() for n, o in zip(names, exes[best].outputs)}
    for i, exe in enumerate(exes):
        if i != best:
            for n, o in zip(names, exe.outputs):
                compare(i, n, o.asnumpy(), truth[n], "predict")
    if grad_req != "null":
        for exe in exes:
            exe.forward(is_train=True)
            exe.backward(list(exe.outputs))
        ref = exes[best]
        truth = {n: o.asnumpy() for n, o in zip(names, ref.outputs)}
        truth.update({"grad:" + n: g.asnumpy()
                      for n, g in ref.grad_dict.items() if g is not None})
        for i, exe in enumerate(exes):
            if i == best:
                continue
            for n, o in zip(names, exe.outputs):
                compare(i, n, o.asnumpy(), truth[n], "train-out")
            for n, g in exe.grad_dict.items():
                if g is not None and "grad:" + n in truth:
                    compare(i, "grad:" + n, g.asnumpy(), truth["grad:" + n],
                            "train-grad")
    truth["max_err"] = max(readings)
    return truth
