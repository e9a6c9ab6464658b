"""Gradients of the GPT's ops in the port against ``jax.vjp`` of the JAX
package's ops, on the same numpy inputs and output gradient.

SoftmaxOutput's gradient is the reference's hand-written one (p - onehot)
* scale; the others come from autograd.  Dropout's bits differ from JAX's
by design, so its keep rate and scaling are checked instead of its masks.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import OpContext as JaxOpContext, \
    get_op as jax_get_op

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import OpContext, get_op
from mxnet_tpu_torch.symbol import eval_graph

RTOL, ATOL = 1e-5, 1e-6     # f32 on the CPU, the same arithmetic


def _both(name, raw_attrs, inputs, diff, seed=0):
    """(port outputs, port grads, JAX outputs, JAX grads) of op ``name``
    on ``inputs`` (numpy), differentiating the inputs whose index is in
    ``diff`` against one random output gradient."""
    jop = jax_get_op(name)
    jattrs = jop.parse_attrs(raw_attrs)

    def jfn(*xs):
        full = list(inputs)
        for i, x in zip(diff, xs):
            full[i] = x
        return jop.fcompute(jattrs, JaxOpContext(), *full)

    jout, vjp = jax.vjp(jfn, *[inputs[i] for i in diff])
    g = np.random.RandomState(seed + 100).normal(
        0, 1, np.shape(jout)).astype(np.float32)
    jgrads = vjp(g)

    op = get_op(name)
    ts = [torch.tensor(np.asarray(x)) for x in inputs]
    for i in diff:
        ts[i].requires_grad_(True)
    out = op.fcompute(op.parse_attrs({k: str(v) for k, v in
                                      raw_attrs.items()}),
                      OpContext(is_train=True), *ts)
    grads = torch.autograd.grad(out, [ts[i] for i in diff],
                                torch.from_numpy(g))
    return out.detach(), grads, np.asarray(jout), jgrads


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True])
def test_softmax_output_gradient_matches_jax(normalization, use_ignore):
    rng = np.random.RandomState(1)
    data = rng.normal(0, 2, (12, 7)).astype(np.float32)
    label = rng.randint(0, 7, (12,)).astype(np.float32)
    label[[2, 5]] = -1.0          # the ignore label (a zero one-hot row)
    label[8] = 9.0                # out of range: a zero one-hot row too
    attrs = {"grad_scale": 0.5, "use_ignore": use_ignore,
             "ignore_label": -1.0, "normalization": normalization}
    out, grads, jout, jgrads = _both("SoftmaxOutput", attrs, [data, label],
                                     diff=(0, 1))
    _close(out, jout)
    _close(grads[0], jgrads[0])
    assert not grads[1].any() and not np.asarray(jgrads[1]).any()


def test_softmax_output_multi_output_gradient_matches_jax():
    rng = np.random.RandomState(2)
    data = rng.normal(0, 1, (3, 5, 4)).astype(np.float32)
    label = rng.randint(0, 5, (3, 4)).astype(np.float32)
    out, grads, jout, jgrads = _both(
        "SoftmaxOutput", {"multi_output": True, "normalization": "valid"},
        [data, label], diff=(0,))
    _close(out, jout)
    _close(grads[0], jgrads[0])


def test_softmax_output_ignores_the_head_gradient():
    """The backward is the loss gradient whatever the head gradient."""
    op = get_op("SoftmaxOutput")
    data = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    label = torch.tensor([0.0, 1.0, 2.0, 3.0])
    grads = []
    for scale in (1.0, 7.0):
        x = data.clone().requires_grad_()
        out = op.fcompute(op.parse_attrs({}), OpContext(is_train=True),
                          x, label)
        grads.append(torch.autograd.grad(out, x,
                                         torch.full_like(out, scale))[0])
    torch.testing.assert_close(grads[0], grads[1])


@pytest.mark.parametrize("flatten", [False, True])
def test_fully_connected_gradient_matches_jax(flatten):
    rng = np.random.RandomState(3)
    data = rng.normal(0, 1, (2, 3, 5)).astype(np.float32)
    k = 15 if flatten else 5
    weight = rng.normal(0, 1, (4, k)).astype(np.float32)
    bias = rng.normal(0, 1, (4,)).astype(np.float32)
    out, grads, jout, jgrads = _both(
        "FullyConnected", {"num_hidden": 4, "flatten": flatten},
        [data, weight, bias], diff=(0, 1, 2))
    _close(out, jout)
    for got, want in zip(grads, jgrads):
        _close(got, want)


def test_layer_norm_gradient_matches_jax():
    rng = np.random.RandomState(4)
    data = rng.normal(1, 2, (3, 4, 8)).astype(np.float32)
    gamma = rng.normal(1, 0.1, (8,)).astype(np.float32)
    beta = rng.normal(0, 0.1, (8,)).astype(np.float32)
    out, grads, jout, jgrads = _both("LayerNorm", {}, [data, gamma, beta],
                                     diff=(0, 1, 2))
    _close(out, jout)
    for got, want in zip(grads, jgrads):
        _close(got, want)


def test_embedding_weight_gradient_matches_jax():
    """Valid rows take the output gradient; a negative index counts from
    the end; the NaN rows of an out-of-range index give no gradient."""
    rng = np.random.RandomState(5)
    weight = rng.normal(0, 1, (10, 6)).astype(np.float32)
    idx = np.array([[0, 3, 3, 9], [-1, 12, 5, 0]], np.float32)
    out, grads, jout, jgrads = _both(
        "Embedding", {"input_dim": 10, "output_dim": 6}, [idx, weight],
        diff=(1,))
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(jout))
    assert np.isnan(out.numpy()[1, 1]).all()
    _close(grads[0], jgrads[0])
    assert np.isfinite(grads[0].numpy()).all()


SHAPE_OPS = [
    ("Reshape", {"shape": (0, 0, 3, 2, -1)}, [(2, 4, 12)]),
    ("Reshape", {"shape": (0, 0, -3, -2)}, [(2, 4, 1, 2, 3)]),
    ("slice_axis", {"axis": 2, "begin": 1, "end": 2}, [(2, 4, 3, 2, 2)]),
    ("broadcast_add", {}, [(2, 4, 6), (1, 4, 6)]),
    ("expand_dims", {"axis": 0}, [(4, 6)]),
    ("elemwise_add", {}, [(3, 5), (3, 5)]),
]


@pytest.mark.parametrize("name,attrs,shapes", SHAPE_OPS,
                         ids=[s[0] + str(i) for i, s in enumerate(SHAPE_OPS)])
def test_shape_op_gradient_matches_jax(name, attrs, shapes):
    rng = np.random.RandomState(6)
    inputs = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    out, grads, jout, jgrads = _both(name, attrs, inputs,
                                     diff=tuple(range(len(inputs))))
    _close(out, jout)
    for got, want in zip(grads, jgrads):
        assert got.shape == np.shape(want)
        _close(got, want)


def test_arange_matches_jax_and_needs_no_gradient():
    attrs = {"start": 0, "stop": 16}
    op = get_op("_arange")
    out = op.fcompute(op.parse_attrs({k: str(v) for k, v in attrs.items()}),
                      OpContext(is_train=True))
    jop = jax_get_op("_arange")
    want = jop.fcompute(jop.parse_attrs(attrs), JaxOpContext())
    _close(out, want)
    assert not out.requires_grad


def test_dropout_keep_rate_scale_and_inference_identity():
    op = get_op("Dropout")
    assert op.stochastic
    attrs = op.parse_attrs({"p": "0.3"})
    x = torch.ones(200000)
    gen = torch.Generator().manual_seed(0)
    y = op.fcompute(attrs, OpContext(is_train=True, generator=gen), x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    # inverted dropout keeps the mean
    assert abs(y.mean().item() - 1.0) < 0.01
    # the same seed gives the same mask; inference is the identity
    y2 = op.fcompute(attrs, OpContext(
        is_train=True, generator=torch.Generator().manual_seed(0)), x)
    assert torch.equal(y, y2)
    assert op.fcompute(attrs, OpContext(is_train=False), x) is x


def test_dropout_in_training_needs_a_generator():
    op = get_op("Dropout")
    with pytest.raises(MXNetError):
        op.fcompute(op.parse_attrs({"p": "0.5"}), OpContext(is_train=True),
                    torch.ones(4))


def _eval_train(net, x, generator):
    topo = net._topo()
    var = next(n for n in topo if n.is_variable)
    heads, _aux = eval_graph(topo, net._entries, {id(var): x},
                             is_train=True, generator=generator)
    return heads[0]


def test_eval_graph_hands_the_generator_to_stochastic_ops_only(monkeypatch):
    """As the JAX package gives a PRNG key only to stochastic ops, the
    port's eval_graph gives its generator only to ops registered
    ``stochastic``; Dropout's mask then comes from that generator."""
    x = torch.ones(1000)
    dropout = get_op("Dropout")
    want = dropout.fcompute(dropout.parse_attrs({"p": "0.5"}), OpContext(
        is_train=True, generator=torch.Generator().manual_seed(0)), x)
    seen = {}

    def spy(name, fcompute):
        def wrapped(attrs, ctx, *inputs):
            seen[name] = ctx.generator
            return fcompute(attrs, ctx, *inputs)
        return wrapped

    for name in ("Dropout", "Activation"):
        op = get_op(name)
        monkeypatch.setattr(op, "fcompute", spy(name, op.fcompute))
    net = tmx.sym.Dropout(tmx.sym.Activation(tmx.sym.Variable("x"),
                                             act_type="relu"), p=0.5)
    gen = torch.Generator().manual_seed(0)
    y = _eval_train(net, x, gen)
    assert seen == {"Activation": None, "Dropout": gen}
    assert torch.equal(y, want)
    with pytest.raises(MXNetError, match="torch.Generator"):
        _eval_train(net, x, None)
