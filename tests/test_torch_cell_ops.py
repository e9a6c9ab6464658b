"""The ops the RNN cells write, and the Symbol arithmetic, in the port
against the JAX package's, on the CPU.

Each op runs on the same numpy inputs in both packages; its outputs and,
against one random output gradient, its input gradients (``jax.vjp`` on
the JAX side, autograd on the port's) agree within rtol 1e-5, atol 1e-6:
f32 on the CPU, the same arithmetic.  The Symbol operators must write the
JAX package's graph JSON node for node.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import OpContext as JaxOpContext, \
    get_op as jax_get_op

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import OpContext, get_op

RTOL, ATOL = 1e-5, 1e-6


def _both(name, raw_attrs, inputs, diff, seed=0):
    """(port outputs, port grads, JAX outputs, JAX grads) of op ``name``,
    outputs as lists, differentiating the inputs whose index is in
    ``diff`` against random output gradients."""
    jop = jax_get_op(name)
    jattrs = jop.parse_attrs(raw_attrs)

    def jfn(*xs):
        full = list(inputs)
        for i, x in zip(diff, xs):
            full[i] = x
        out = jop.fcompute(jattrs, JaxOpContext(), *full)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    jout, vjp = jax.vjp(jfn, *[inputs[i] for i in diff])
    rng = np.random.RandomState(seed + 100)
    gs = [rng.normal(0, 1, np.shape(o)).astype(np.float32) for o in jout]
    jgrads = vjp(tuple(gs)) if diff else ()

    op = get_op(name)
    ts = [torch.tensor(np.asarray(x)) for x in inputs]
    for i in diff:
        ts[i].requires_grad_(True)
    out = op.fcompute(op.parse_attrs({k: str(v) for k, v in
                                      raw_attrs.items()}),
                      OpContext(is_train=True), *ts)
    out = list(out) if isinstance(out, (tuple, list)) else [out]
    grads = torch.autograd.grad(out, [ts[i] for i in diff],
                                [torch.from_numpy(g) for g in gs]) \
        if diff else ()
    return [o.detach() for o in out], grads, [np.asarray(o) for o in jout], \
        jgrads


def _check(name, attrs, inputs, diff):
    out, grads, jout, jgrads = _both(name, attrs, inputs, diff)
    assert len(out) == len(jout)
    for o, j in zip(out, jout):
        assert tuple(o.shape) == j.shape
        np.testing.assert_allclose(o.numpy(), j, RTOL, ATOL)
    for g, j in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), RTOL, ATOL)


def _n(*shape, seed=0, lo=None):
    x = np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)
    return x if lo is None else np.abs(x) + lo


@pytest.mark.parametrize("name", ["elemwise_sub", "elemwise_mul",
                                  "elemwise_div", "_power", "_minus",
                                  "_mul", "_div"])
def test_binary_ops_match_jax(name):
    lhs = _n(3, 5, lo=0.5) if name == "_power" else _n(3, 5)
    _check(name, {}, [lhs, _n(3, 5, seed=1, lo=0.5)], diff=(0, 1))


@pytest.mark.parametrize("name,scalar", [
    ("_plus_scalar", 1.5), ("_minus_scalar", 0.25), ("_rminus_scalar", 1.0),
    ("_mul_scalar", -2.0), ("_div_scalar", 4.0), ("_rdiv_scalar", 2.0),
    ("_power_scalar", 2.0), ("_rpower_scalar", 1.7),
    ("_maximum_scalar", 0.1), ("_minimum_scalar", 0.1),
    ("_mod_scalar", 0.7), ("_equal_scalar", 0.0),
    ("_not_equal_scalar", 0.0), ("_greater_scalar", 0.2),
    ("_greater_equal_scalar", 0.2), ("_lesser_scalar", -0.2),
    ("_lesser_equal_scalar", -0.2)])
def test_scalar_ops_match_jax(name, scalar):
    x = _n(4, 6, lo=0.3) if name in ("_rdiv_scalar", "_power_scalar") \
        else _n(4, 6)
    x[0, :2] = scalar          # ties of the comparisons
    compare = name.endswith(("equal_scalar", "greater_scalar",
                             "lesser_scalar")) or name == "_mod_scalar"
    _check(name, {"scalar": scalar}, [x], diff=() if compare else (0,))


def test_negative_and_where_match_jax():
    _check("negative", {}, [_n(3, 4)], diff=(0,))
    cond = (np.random.RandomState(3).rand(3, 4) > 0.5).astype(np.float32)
    _check("where", {}, [cond, _n(3, 4), _n(3, 4, seed=1)], diff=(1, 2))
    rows = np.array([1, 0, 1], np.float32)          # a 1-d condition
    _check("where", {}, [rows, _n(3, 4), _n(3, 4, seed=1)], diff=(1, 2))


@pytest.mark.parametrize("name", ["_zeros", "_ones"])
def test_init_ops_match_jax(name):
    _check(name, {"shape": (2, 3), "dtype": "float32"}, [], diff=())


@pytest.mark.parametrize("name", ["zeros_like", "ones_like"])
def test_like_ops_match_jax(name):
    """Forward only: the output does not depend on the input's values, so
    the JAX gradient is zero and autograd records no graph."""
    _check(name, {}, [_n(2, 5)], diff=())
    out = get_op(name).fcompute({}, OpContext(is_train=True),
                                torch.ones(2, requires_grad=True))
    assert not out.requires_grad


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_concat_matches_jax(dim):
    ins = [_n(2, 3, 4, seed=i) for i in range(3)]
    _check("Concat", {"num_args": 3, "dim": dim}, ins, diff=(0, 1, 2))


@pytest.mark.parametrize("axis,squeeze", [(1, False), (0, False),
                                          (1, True), (2, True)])
def test_slice_channel_matches_jax(axis, squeeze):
    x = _n(4, 4, 4)
    n = 4
    _check("SliceChannel", {"num_outputs": n, "axis": axis,
                            "squeeze_axis": squeeze}, [x], diff=(0,))


def test_slice_channel_refuses_an_uneven_split():
    op = get_op("SliceChannel")
    with pytest.raises(MXNetError, match="does not split"):
        op.fcompute(op.parse_attrs({"num_outputs": "3"}), OpContext(),
                    torch.zeros(2, 4))


def test_swap_axis_matches_jax():
    _check("SwapAxis", {"dim1": 0, "dim2": 2}, [_n(2, 3, 4)], diff=(0,))


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation_matches_jax(act):
    x = _n(5, 7) * 4
    x[0, 0] = 30.0          # softrelu's large-x branch
    _check("Activation", {"act_type": act}, [x], diff=(0,))


def test_unknown_activation_raises():
    op = get_op("Activation")
    with pytest.raises(MXNetError, match="unknown act_type"):
        op.fcompute(op.parse_attrs({"act_type": "gelu"}), OpContext(),
                    torch.zeros(2))


def _exprs(mx):
    a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
    return mx.sym.Group([
        a - b, a * b, a / b, a ** b, -a, a + 2, 2 + a, a - 2, 2 - a,
        a * 3, 3 * a, a / 4, 4 / a, a ** 2,
        mx.sym.where(a, b, a),
        mx.sym.Concat(a, b, a, dim=0),
        mx.sym.zeros((0, 3)) + mx.sym.ones((0, 3)),
    ])


def test_symbol_arithmetic_writes_the_jax_graph_and_values():
    jnet, tnet = _exprs(jmx), _exprs(tmx)
    assert tnet.tojson() == jnet.tojson()
    assert tnet.list_outputs() == jnet.list_outputs()
    rng = np.random.RandomState(0)
    a = (np.abs(rng.normal(0, 1, (2, 3))) + 0.5).astype(np.float32)
    b = (np.abs(rng.normal(0, 1, (2, 3))) + 0.5).astype(np.float32)
    jexe = jnet.bind(jmx.cpu(), {"a": jmx.nd.array(a), "b": jmx.nd.array(b)})
    texe = tnet.bind(tmx.cpu(), {"a": tmx.nd.array(a, ctx=tmx.cpu()),
                                 "b": tmx.nd.array(b, ctx=tmx.cpu())})
    for t, j in zip(texe.forward(), jexe.forward()):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), RTOL, ATOL)
    # the 0 of sym.zeros((0, 3)) is the batch: a's leading dim
    assert texe.outputs[-1].shape == (2, 3)
    with pytest.raises(TypeError, match="unsupported operand"):
        tmx.sym.Variable("a") - "b"


def test_symbol_iterates_its_outputs():
    parts = tmx.sym.SliceChannel(tmx.sym.Variable("x"), num_outputs=3)
    assert len(parts) == 3
    first, _second, third = parts
    assert first.list_outputs()[0].endswith("_output0")
    assert third.list_outputs()[0].endswith("_output2")
    assert [p.list_outputs()[0] for p in parts] == parts.list_outputs()


def test_infer_shape_fills_the_batch_of_zero_dims():
    x = tmx.sym.Variable("x")
    y = tmx.sym.FullyConnected(x, num_hidden=4, name="fc") + \
        tmx.sym.zeros((0, 4))
    args, outs, _ = y.infer_shape(x=(5, 3))
    assert outs == [(5, 4)] and args[1] == (4, 3)
    jx = jmx.sym.Variable("x")
    jy = jmx.sym.FullyConnected(jx, num_hidden=4, name="fc") + \
        jmx.sym.zeros((0, 4))
    assert jy.infer_shape(x=(5, 3))[1] == outs
