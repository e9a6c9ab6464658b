"""The port's NDArray surface against the JAX NDArray's on the CPU: every
operator with array, broadcast, scalar and numpy operands (reflected ones
included), the in-place operators (which keep the storage), comparisons
(0/1 arrays here, booleans there: compared by value), the methods and the
module's functions; then ``nd.<op>``'s dispatch (named inputs, counted
``num_args``, auxiliary write-back, ``out=`` with its dtype, ``ctx=``,
outputs that never share an input's storage).  f32; rtol 1e-6 and atol
1e-6 where the two compute the same arithmetic, exact where they copy."""
import io
import operator

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

RTOL = ATOL = 1e-6
CPU = mx.cpu()

_rng = np.random.RandomState(0)
A = _rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
B = _rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
ROW = _rng.uniform(0.5, 2.0, (1, 4)).astype(np.float32)
B[0, :2] = A[0, :2]                  # ties for the comparisons


def both(x):
    return mx.nd.array(x, ctx=CPU), jmx.nd.array(x)


def same(got, want, exact=False):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    else:
        np.testing.assert_allclose(got, want.astype(np.float64), RTOL, ATOL)


OPS = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
       "truediv": operator.truediv, "mod": operator.mod,
       "pow": operator.pow}
OPERANDS = {"array": B, "broadcast": ROW, "scalar": 1.5, "int": 2,
            "numpy": B}


@pytest.mark.parametrize("other", sorted(OPERANDS))
@pytest.mark.parametrize("op", sorted(OPS))
def test_binary_operator(op, other):
    fn = OPS[op]
    a, ja = both(A)
    o = OPERANDS[other]
    if other in ("array", "broadcast"):
        o, jo = both(o)
    else:
        jo = o
    same(fn(a, o), fn(ja, jo))


@pytest.mark.parametrize("other", ["scalar", "int"])
@pytest.mark.parametrize("op", sorted(set(OPS) - {"mod"}))
def test_reflected_operator(op, other):
    fn = OPS[op]
    a, ja = both(A)
    o = OPERANDS[other]
    same(fn(o, a), fn(o, ja))


CMPS = {"eq": operator.eq, "ne": operator.ne, "gt": operator.gt,
        "ge": operator.ge, "lt": operator.lt, "le": operator.le}


@pytest.mark.parametrize("other", ["array", "broadcast", "scalar"])
@pytest.mark.parametrize("op", sorted(CMPS))
def test_comparison_gives_zero_one(op, other):
    a, ja = both(A)
    if other == "scalar":
        o = jo = float(A[0, 0])
    else:
        o, jo = both(B if other == "array" else ROW)
    got = CMPS[op](a, o)
    assert got.dtype == np.float32
    same(got, CMPS[op](ja, jo), exact=True)


IOPS = {"iadd": operator.iadd, "isub": operator.isub,
        "imul": operator.imul, "itruediv": operator.itruediv}


@pytest.mark.parametrize("other", ["array", "broadcast", "scalar"])
@pytest.mark.parametrize("op", sorted(IOPS))
def test_inplace_operator_keeps_the_storage(op, other):
    a, ja = both(A)
    view = a[1:3]
    ptr = a.data.data_ptr()
    o = 1.5 if other == "scalar" else (B if other == "array" else ROW)
    if other != "scalar":
        o, jo = both(o)
    else:
        jo = o
    res = IOPS[op](a, o)
    jres = IOPS[op](ja, jo)
    assert res is a and a.data.data_ptr() == ptr
    same(a, jres)
    same(view, jres.asnumpy()[1:3])


def test_unary_operators():
    a, ja = both(A - 1.0)
    same(-a, -ja)
    same(abs(a), abs(ja))


@pytest.mark.parametrize("axis,keepdims", [(None, False), (1, False),
                                           (0, True), ((0, 1), False)])
@pytest.mark.parametrize("method", ["sum", "mean", "max", "min"])
def test_reduction_method(method, axis, keepdims):
    a, ja = both(A)
    same(getattr(a, method)(axis=axis, keepdims=keepdims),
         getattr(ja, method)(axis=axis, keepdims=keepdims))


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("method", ["argmax", "argmin"])
def test_arg_method(method, axis):
    x = np.array([[1, 3, 3, 0], [2, 2, 0, 0], [0, 1, 3, 3]], np.float32)
    a, ja = both(x)
    got, want = getattr(a, method)(axis=axis), getattr(ja, method)(axis=axis)
    assert got.dtype == want.dtype == np.int32
    same(got, want, exact=True)


def test_shape_methods():
    a, ja = both(A)
    same(a.T, ja.T, exact=True)
    assert a.astype("float16").dtype == ja.astype("float16").dtype
    same(a.astype("int32"), ja.astype("int32"), exact=True)
    same(a.broadcast_to((2, 3, 4)), ja.broadcast_to((2, 3, 4)), exact=True)
    same(a.flatten(), ja.flatten(), exact=True)
    same(a.reshape((4, 3)), ja.reshape((4, 3)), exact=True)
    same(a.reshape((0, -1)), ja.reshape((0, -1)), exact=True)
    same(a.slice(1, 3), ja.slice(1, 3), exact=True)
    same(a.at(2), ja.at(2), exact=True)
    same(a[1], ja[1], exact=True)
    assert (a.ndim, len(a), a.shape, a.size) == \
        (ja.ndim, len(ja), ja.shape, ja.size)
    with pytest.raises(TypeError):
        len(mx.nd.array(np.float32(1.0), ctx=CPU))


def test_scalar_and_host_methods():
    a, ja = both(np.array([2.5], np.float32))
    assert a.asscalar() == ja.asscalar() == a.item() == 2.5
    assert bool(a) and bool(mx.nd.zeros((1,), ctx=CPU)) is False
    with pytest.raises(ValueError):
        bool(mx.nd.ones((2,), ctx=CPU))
    m, jm = both(A)
    np.testing.assert_array_equal(np.asarray(m), np.asarray(jm))
    assert np.asarray(m, dtype=np.float64).dtype == np.float64
    m.wait_to_read()
    m.wait_to_write()


def test_copies_and_contexts():
    a, _ja = both(A)
    c = a.copy()
    c += 1
    same(a, A)
    d = mx.nd.zeros((3, 4), ctx=CPU)
    assert a.copyto(d) is d
    same(d, A, exact=True)
    e = a.copyto(mx.cpu())
    assert e is not a and e.context == mx.cpu() == a.ctx
    assert a.as_in_context(mx.cpu()) is a


def test_setitem_writes_the_storage():
    a, ja = both(A)
    ptr = a.data.data_ptr()
    a[1] = 0.5
    ja[1] = 0.5
    a[:, 2] = np.arange(3, dtype=np.float32)
    ja[:, 2] = np.arange(3, dtype=np.float32)
    assert a.data.data_ptr() == ptr
    same(a, ja, exact=True)


def test_creation_functions():
    pairs = [
        (mx.nd.full((2, 3), 7.5, ctx=CPU), jmx.nd.full((2, 3), 7.5)),
        (mx.nd.arange(5, ctx=CPU), jmx.nd.arange(0, 5)),
        (mx.nd.arange(1, 4, 0.5, repeat=2, ctx=CPU),
         jmx.nd.arange(1, 4, 0.5, repeat=2)),
        (mx.nd.zeros_like(mx.nd.array(A, ctx=CPU)),
         jmx.nd.zeros_like(jmx.nd.array(A))),
        (mx.nd.ones_like(mx.nd.array(A, ctx=CPU)),
         jmx.nd.ones_like(jmx.nd.array(A))),
        (mx.nd.concatenate([mx.nd.array(A, ctx=CPU),
                            mx.nd.array(B, ctx=CPU)], axis=1),
         jmx.nd.concatenate([jmx.nd.array(A), jmx.nd.array(B)], axis=1))]
    for got, want in pairs:
        same(got, want, exact=True)
    idx, jidx = both(np.array([0, 2, 1], np.float32))
    out, jout = mx.nd.zeros((3, 4), ctx=CPU), jmx.nd.zeros((3, 4))
    assert mx.nd.onehot_encode(idx, out) is out
    same(out, jmx.nd.onehot_encode(jidx, jout), exact=True)


def test_imdecode_delegates_to_image():
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray((np.arange(48).reshape(4, 4, 3) * 5).astype(np.uint8)) \
        .save(buf, format="PNG")
    got = mx.nd.imdecode(buf.getvalue())
    same(got, jmx.nd.imdecode(buf.getvalue()), exact=True)


def test_attach_grad_and_backward():
    a, ja = both(A)
    for x in (a, ja):
        x.attach_grad()
    with mx.autograd.record():
        y = (a * a + 2 * a).sum()
    with jmx.autograd.record():
        jy = (ja * ja + 2 * ja).sum()
    y.backward()
    jy.backward()
    same(a.grad, ja.grad)
    same(a.grad, 2 * A + 2)


# ------------------------------------------------------------- the dispatch
def test_named_inputs_and_counted_num_args():
    a, ja = both(A)
    b, jb = both(B)
    same(mx.nd.add_n(a, b, a), jmx.nd.add_n(ja, jb, ja))
    same(mx.nd.broadcast_sub(lhs=a, rhs=b), jmx.nd.broadcast_sub(lhs=ja,
                                                                 rhs=jb))
    same(mx.nd.FullyConnected(a, weight=b, no_bias=True, num_hidden=3),
         jmx.nd.FullyConnected(ja, weight=jb, no_bias=True, num_hidden=3))
    with pytest.raises(mx.MXNetError, match="missing inputs"):
        mx.nd.FullyConnected(a, num_hidden=3)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_writes_its_moving_statistics_back(train):
    rng = np.random.RandomState(2)
    x = rng.normal(3, 2, (4, 3, 2, 2)).astype(np.float32)
    ins = [x, np.ones(3, np.float32), np.zeros(3, np.float32),
           rng.normal(0, 1, 3).astype(np.float32),
           rng.uniform(0.5, 1.5, 3).astype(np.float32)]
    arrs = [mx.nd.array(v, ctx=CPU) for v in ins]
    jarrs = [jmx.nd.array(v) for v in ins]
    kw = {"fix_gamma": False, "momentum": 0.8}
    if train:
        with mx.autograd.record():
            out = mx.nd.BatchNorm(*arrs, **kw)
        with jmx.autograd.record():
            jout = jmx.nd.BatchNorm(*jarrs, **kw)
    else:
        out, jout = mx.nd.BatchNorm(*arrs, **kw), jmx.nd.BatchNorm(*jarrs,
                                                                 **kw)
    same(out, jout)
    for got, want in zip(arrs[3:], jarrs[3:]):
        same(got, want)
    assert np.allclose(arrs[3].asnumpy(), ins[3]) != train


def test_out_takes_the_result_in_its_dtype():
    a, ja = both(A)
    out = mx.nd.zeros((3, 4), ctx=CPU, dtype="float16")
    jout = jmx.nd.zeros((3, 4), dtype="float16")
    ptr = out.data.data_ptr()
    assert mx.nd.exp(a, out=out) is out
    jmx.nd.exp(ja, out=jout)
    assert out.dtype == np.float16 and out.data.data_ptr() == ptr
    np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())


def test_ops_without_inputs_take_ctx():
    z = mx.nd._full(shape=(2, 2), value=3.0, ctx=CPU)
    assert z.context == CPU
    same(z, jmx.nd._full(shape=(2, 2), value=3.0), exact=True)
    r = mx.nd.uniform(shape=(3,), ctx=CPU)
    assert r.context == CPU and r.shape == (3,)


@pytest.mark.parametrize("op,kw", [("identity", {}), ("_copy", {}),
                                   ("Reshape", {"shape": (4, 3)}),
                                   ("expand_dims", {"axis": 0}),
                                   ("transpose", {}),
                                   ("squeeze", {}), ("BlockGrad", {}),
                                   ("slice_axis", {"axis": 0, "begin": 1,
                                                   "end": 3})])
def test_outputs_never_share_the_input_storage(op, kw):
    a = mx.nd.array(A, ctx=CPU)
    out = getattr(mx.nd, op)(a, **kw)
    out += 1
    same(a, A, exact=True)


def test_aliases_resolve():
    from mxnet_tpu_torch.ops.registry import aliases, get_op
    from mxnet_tpu.ops import registry as jreg
    for alias, target in aliases().items():
        assert get_op(alias).name == target == jreg._ALIASES[alias]
        assert getattr(mx.nd, alias) is getattr(mx.nd, target)
        assert callable(getattr(mx.sym, alias))
