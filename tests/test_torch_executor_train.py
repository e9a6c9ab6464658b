"""The port's training Executor against the JAX package's, on the CPU.

One graph (built with the JAX ``mx.sym`` and loaded into the port from its
JSON) is bound in both packages with the same numpy-made argument values:
``bind``/``simple_bind`` with ``grad_req`` write, add and null,
``forward(is_train=True)``, ``backward`` with and without head gradients,
and BatchNorm's moving statistics, on an MLP, a conv+BN net and the GPT
(vocab 64, seq 128, d 32, 2 layers, dropout 0).  Outputs, gradients and
auxiliary values agree within rtol 1e-5, with an atol of 1e-6 of the
array's largest entry: the same f32 arithmetic, summed in other orders by
another library, and a gradient summed over many tokens can cancel to an
entry far below the terms whose rounding it carries (the GPT's ln_f_gamma
holds 0.031 among entries of 48).  Dropout draws from
another generator in each package, so it is held to its rate and to
same-seed determinism instead, never to the JAX bits.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples", "transformer"))

import train_lm  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _mlp():
    net = jmx.sym.Variable("data")
    net = jmx.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = jmx.sym.Activation(net, act_type="relu")
    net = jmx.sym.FullyConnected(net, num_hidden=5, name="fc2")
    return jmx.sym.SoftmaxOutput(net, name="softmax")


def _conv_bn():
    net = jmx.sym.Variable("data")
    net = jmx.sym.Convolution(net, kernel=(3, 3), pad=(1, 1), num_filter=4,
                              name="conv1")
    net = jmx.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = jmx.sym.Activation(net, act_type="relu")
    net = jmx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2),
                          pool_type="max")
    net = jmx.sym.Flatten(net)
    net = jmx.sym.FullyConnected(net, num_hidden=3, name="fc")
    return jmx.sym.SoftmaxOutput(net, name="softmax")


def _gpt():
    return train_lm.gpt_symbol(64, 128, d_model=32, n_heads=2, n_layers=2,
                               dropout=0.0)


NETS = {
    "mlp": (_mlp, {"data": (4, 12), "softmax_label": (4,)}, 5),
    "conv_bn": (_conv_bn, {"data": (3, 2, 8, 8), "softmax_label": (3,)}, 3),
    "gpt": (_gpt, {"data": (2, 128), "softmax_label": (2, 128)}, 64),
}


def _values(jnet, shapes, classes, seed=0):
    """Argument and auxiliary values from a seed: labels and token ids as
    integers below ``classes``, weights N(0, 0.3), moving variances
    positive."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = jnet.infer_shape(**shapes)
    args = {}
    for n, s in zip(jnet.list_arguments(), arg_shapes):
        if n == "softmax_label" or (n == "data" and classes == 64):
            args[n] = rng.randint(0, classes, s).astype(np.float32)
        else:
            args[n] = (rng.randn(*s) * 0.3).astype(np.float32)
    aux = {}
    for n, s in zip(jnet.list_auxiliary_states(), aux_shapes):
        aux[n] = (rng.rand(*s) + 0.5 if n.endswith("var")
                  else rng.randn(*s) * 0.1).astype(np.float32)
    return args, aux


def _bind_both(name, grad_req="write", seed=0):
    build, shapes, classes = NETS[name]
    jnet = build()
    pnet = tmx.sym.load_json(jnet.tojson())
    args, aux = _values(jnet, shapes, classes, seed)
    jexe = jnet.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in args.items()},
                     grad_req=grad_req,
                     aux_states={k: jmx.nd.array(v) for k, v in aux.items()})
    pexe = pnet.bind(tmx.cpu(),
                     {k: tmx.nd.array(v, ctx=tmx.cpu())
                      for k, v in args.items()},
                     grad_req=grad_req,
                     aux_states={k: tmx.nd.array(v, ctx=tmx.cpu())
                                 for k, v in aux.items()})
    return jexe, pexe


def _close(got, want, msg=""):
    want = np.asarray(want.asnumpy())
    np.testing.assert_allclose(got.asnumpy(), want, RTOL,
                               ATOL * max(np.abs(want).max(), 1.0),
                               err_msg=msg)


def _check_grads(jexe, pexe, names=None):
    for n, g in jexe.grad_dict.items():
        if names is not None and n not in names:
            continue
        _close(pexe.grad_dict[n], g, n)


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_backward_matches_jax(name):
    """forward(is_train=True) then backward(): the outputs and every
    gradient, BatchNorm's updated moving statistics included."""
    jexe, pexe = _bind_both(name)
    jout = jexe.forward(is_train=True)
    pout = pexe.forward(is_train=True)
    for p, j in zip(pout, jout):
        _close(p, j)
    jexe.backward()
    pexe.backward()
    _check_grads(jexe, pexe)
    for n, a in jexe.aux_dict.items():
        _close(pexe.aux_dict[n], a, n)


@pytest.mark.parametrize("name", ["mlp", "conv_bn"])
def test_simple_bind_allocates_and_runs(name):
    """simple_bind infers every shape and makes zero args, grads and aux on
    the context; after the values are set it gives the JAX gradients."""
    build, shapes, classes = NETS[name]
    jnet = build()
    pnet = tmx.sym.load_json(jnet.tojson())
    jexe = jnet.simple_bind(ctx=jmx.cpu(), **shapes)
    pexe = pnet.simple_bind(ctx=tmx.cpu(), **shapes)
    assert sorted(pexe.grad_dict) == sorted(jexe.grad_dict)
    for n, arr in pexe.arg_dict.items():
        assert arr.shape == tuple(jexe.arg_dict[n].shape)
        assert not arr.asnumpy().any()
    args, aux = _values(jnet, shapes, classes)
    for exe in (jexe, pexe):
        for n, v in args.items():
            exe.arg_dict[n][:] = v
        for n, v in aux.items():
            exe.aux_dict[n][:] = v
    jexe.forward_backward()
    pexe.forward_backward()
    _check_grads(jexe, pexe)


def test_grad_req_add_accumulates_and_write_overwrites():
    """'add' sums two backward passes into the grad arrays; 'write' gives
    one pass's gradient however often it runs."""
    jexe, pexe = _bind_both("mlp", grad_req="add")
    for _ in range(2):
        jexe.forward(is_train=True)
        jexe.backward()
        pexe.forward(is_train=True)
        pexe.backward()
    _check_grads(jexe, pexe)
    _jw, pw = _bind_both("mlp", grad_req="write")
    for _ in range(2):
        pw.forward(is_train=True)
        pw.backward()
    for n, g in pexe.grad_dict.items():
        np.testing.assert_allclose(g.asnumpy(), 2 * pw.grad_dict[n].asnumpy(),
                                   RTOL, ATOL, err_msg=n)


def test_grad_req_null_per_argument():
    """A dict of grad_req: 'null' arguments have no grad array and the
    others get the JAX gradients."""
    req = {"fc1_weight": "null", "fc1_bias": "write", "fc2_weight": "write",
           "fc2_bias": "null", "data": "null", "softmax_label": "null"}
    jexe, pexe = _bind_both("mlp", grad_req=req)
    assert pexe.grad_arrays[pexe._arg_names.index("fc1_weight")] is None
    jexe.forward(is_train=True)
    jexe.backward()
    pexe.forward(is_train=True)
    pexe.backward()
    _check_grads(jexe, pexe, names={"fc1_bias", "fc2_weight"})
    assert set(n for n, r in pexe.grad_req.items() if r != "null") == \
        {"fc1_bias", "fc2_weight"}


def test_backward_with_head_gradients():
    """A graph whose head is not a loss: backward(out_grads) takes the head
    gradient; backward() without it seeds zeros, so every gradient is 0."""
    data = jmx.sym.Variable("data")
    jnet = jmx.sym.FullyConnected(data, num_hidden=6, name="fc")
    pnet = tmx.sym.load_json(jnet.tojson())
    rng = np.random.RandomState(3)
    x = rng.randn(5, 7).astype(np.float32)
    w = rng.randn(6, 7).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    head = rng.randn(5, 6).astype(np.float32)
    jexe = jnet.bind(jmx.cpu(), {"data": jmx.nd.array(x),
                                 "fc_weight": jmx.nd.array(w),
                                 "fc_bias": jmx.nd.array(b)})
    pexe = pnet.bind(tmx.cpu(), {"data": tmx.nd.array(x, ctx=tmx.cpu()),
                                 "fc_weight": tmx.nd.array(w, ctx=tmx.cpu()),
                                 "fc_bias": tmx.nd.array(b, ctx=tmx.cpu())})
    jexe.forward(is_train=True)
    jexe.backward(out_grads=[jmx.nd.array(head)])
    pexe.forward(is_train=True)
    pexe.backward(out_grads=[tmx.nd.array(head, ctx=tmx.cpu())])
    _check_grads(jexe, pexe)
    pexe.forward(is_train=True)
    pexe.backward()
    assert all(not g.asnumpy().any() for g in pexe.grad_dict.values())


def test_backward_needs_a_training_forward():
    _j, pexe = _bind_both("mlp")
    with pytest.raises(MXNetError, match="forward"):
        pexe.backward()
    pexe.forward(is_train=False)
    with pytest.raises(MXNetError, match="is_train=True"):
        pexe.backward()


def test_inference_forward_keeps_params_trainable():
    """forward(is_train=False) runs in inference mode; the argument arrays
    stay ordinary tensors, so a training forward and backward after it
    still work, and the inference outputs are the JAX ones."""
    jexe, pexe = _bind_both("conv_bn")
    _close(pexe.forward(is_train=False)[0], jexe.forward(is_train=False)[0])
    assert not any(a.data.is_inference() for a in pexe.arg_dict.values())
    jexe.forward(is_train=True)
    jexe.backward()
    pexe.forward(is_train=True)
    pexe.backward()
    _check_grads(jexe, pexe)


def test_forward_kwargs_and_copy_params_from():
    """forward(**inputs) writes the inputs in place; copy_params_from loads
    params and aux, and refuses unknown names unless told to ignore
    them."""
    jexe, pexe = _bind_both("mlp")
    x = np.random.RandomState(4).randn(4, 12).astype(np.float32)
    _close(pexe.forward(data=x)[0], jexe.forward(data=jmx.nd.array(x))[0])
    w = np.ones((16, 12), np.float32)
    pexe.copy_params_from({"fc1_weight": tmx.nd.array(w, ctx=tmx.cpu())})
    assert (pexe.arg_dict["fc1_weight"].asnumpy() == 1).all()
    with pytest.raises(MXNetError, match="unknown argument"):
        pexe.copy_params_from({"nope": tmx.nd.array(w, ctx=tmx.cpu())})
    pexe.copy_params_from({"nope": tmx.nd.array(w, ctx=tmx.cpu())},
                          allow_extra_params=True)


def test_block_fusion_is_captured_at_bind():
    from mxnet_tpu_torch.ops.fused import block_fusion
    pnet = tmx.sym.load_json(_mlp().tojson())
    with block_fusion(True):
        exe = pnet.simple_bind(ctx=tmx.cpu(), data=(4, 12),
                               softmax_label=(4,))
    assert exe._block_fusion is True
    assert pnet.simple_bind(ctx=tmx.cpu(), data=(4, 12),
                            softmax_label=(4,))._block_fusion is False


def _dropout_exe(p, shape=(64, 256)):
    net = tmx.sym.Dropout(tmx.sym.Variable("data"), p=p)
    return net.bind(tmx.cpu(), {"data": tmx.nd.ones(shape, ctx=tmx.cpu())},
                    grad_req="null")


def test_dropout_rate_and_scale():
    """Training forward zeroes a share p of the entries (within 4 sigma of
    a binomial over 16384) and scales the rest by 1 / (1 - p); inference
    is the identity."""
    p = 0.3
    exe = _dropout_exe(p)
    tmx.random.seed(11)
    y = exe.forward(is_train=True)[0].asnumpy()
    zero = (y == 0).mean()
    sigma = np.sqrt(p * (1 - p) / y.size)
    assert abs(zero - p) < 4 * sigma
    np.testing.assert_allclose(y[y != 0], 1.0 / (1 - p), rtol=1e-6)
    assert (exe.forward(is_train=False)[0].asnumpy() == 1).all()


def test_dropout_same_seed_same_bits():
    """mx.random.seed makes the draws repeat; another seed changes them."""
    exe = _dropout_exe(0.5)
    tmx.random.seed(5)
    a = exe.forward(is_train=True)[0].asnumpy()
    b = exe.forward(is_train=True)[0].asnumpy()
    tmx.random.seed(5)
    a2 = exe.forward(is_train=True)[0].asnumpy()
    b2 = exe.forward(is_train=True)[0].asnumpy()
    tmx.random.seed(6)
    c = exe.forward(is_train=True)[0].asnumpy()
    assert np.array_equal(a, a2) and np.array_equal(b, b2)
    assert not np.array_equal(a, b) and not np.array_equal(a, c)
    assert tmx.random.generator(torch.device("cpu")) is \
        tmx.random.generator("cpu")


def test_gpu_context_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pnet = tmx.sym.load_json(_mlp().tojson())
    with pytest.raises(MXNetError, match="no CUDA device"):
        pnet.simple_bind(ctx=tmx.gpu(0), data=(4, 12), softmax_label=(4,))
