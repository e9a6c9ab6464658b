"""The JAX package's side of the op corpus
(``mxnet_tpu_torch.tools.op_corpus``): a case's outputs and its gradient of
``sum(out * cot)`` through the JAX op, on the same numpy inputs and
cotangents as the port's :func:`~mxnet_tpu_torch.tools.op_corpus.run`.
Each case is one ``jax.jit`` of the op and its vjp (one compile a case,
not one a primitive)."""
import jax
import jax.numpy as jnp
import numpy as np

from mxnet_tpu.ops.registry import OpContext as JaxOpContext, \
    get_op as jax_get_op

from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.tools.op_corpus import (
    CASES, compare, cotangents, inputs_of, run)

#: the worst relative error of an output or a gradient (of max |ref|)
#: against the JAX op, f32 on the CPU: the corpus reads at most 1.9e-6
#: (gamma at negative x); a clip whose bounds pass the whole gradient
#: (torch.clamp's rule) reads 0.56
TOL = 1e-5


def jax_run(case, seed=0):
    jop = jax_get_op(case.op)
    attrs = jop.parse_attrs(case.attrs)
    inputs = inputs_of(case, seed)

    def f(*xs):
        full = list(inputs)
        for i, x in zip(case.diff, xs):
            full[i] = x
        out = jop.fcompute(attrs, JaxOpContext(is_train=case.train), *full)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    if not case.diff:
        return [np.asarray(o) for o in jax.jit(f)()], []
    dx = [inputs[i] for i in case.diff]
    shapes = jax.eval_shape(f, *dx)
    n_vis = jop.get_num_outputs(attrs)
    floats = [i for i in range(n_vis)
              if jnp.issubdtype(shapes[i].dtype, jnp.inexact)]
    cots = [np.zeros(s.shape, s.dtype) for s in shapes]
    for i, c in zip(floats, cotangents([shapes[i].shape for i in floats],
                                       seed)):
        cots[i] = c.astype(shapes[i].dtype)

    def fg(dx, cots):
        outs, vjp = jax.vjp(f, *dx)
        return outs, vjp(tuple(cots))

    outs, grads = jax.jit(fg)(dx, cots)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def cases_of(module):
    """The corpus cases whose port op is defined in ``ops/<module>.py``."""
    return [c for c in CASES
            if get_op(c.op).fcompute.__module__.endswith("." + module)]


def check_case(case):
    outs, grads = run(case, "cpu")
    jouts, jgrads = jax_run(case)
    assert len(outs) == len(jouts)
    err = compare(case, outs, jouts)
    assert err <= TOL, "%s: outputs off by %g" % (case.id, err)
    if case.diff:
        err = compare(case, grads, jgrads)
        assert err <= TOL, "%s: gradients off by %g" % (case.id, err)
