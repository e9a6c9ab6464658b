"""The port's nn ops (``ops/nn.py``: Deconvolution, the normalizations,
LeakyReLU, the softmaxes, the loss heads with their own backward, the KL
regulariser with its ``moving_avg``, Pad, UpSampling, Crop, the sequence
ops; the 1-d and 3-d Convolution and Pooling and ``LayerNorm
output_mean_var``) and the registered update ops against the JAX
package's on the CPU, through the op corpus (``tests/torch_corpus_oracle.py``,
within its ``TOL``); then parameter-shape inference, rrelu in training and
the update ops as Symbols."""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

from torch_corpus_oracle import cases_of, check_case

CASES = cases_of("nn") + cases_of("optimizer_ops")


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case):
    check_case(case)


def test_the_corpus_covers_the_nn_and_update_ops():
    new = {"Deconvolution", "InstanceNorm", "L2Normalization", "LRN",
           "LeakyReLU", "softmax", "log_softmax", "SoftmaxActivation",
           "LinearRegressionOutput", "MAERegressionOutput",
           "LogisticRegressionOutput", "SVMOutput", "MakeLoss",
           "IdentityAttachKLSparseReg", "LSoftmax", "BlockGrad", "Pad",
           "UpSampling", "Crop", "SequenceMask", "SequenceLast",
           "SequenceReverse", "softmax_cross_entropy", "sgd_update",
           "sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update"}
    assert len(new) == 28
    assert new <= {c.op for c in CASES}


def _dcgan_like(sym):
    rand = sym.Variable("rand")
    g = sym.Deconvolution(rand, name="g1", kernel=(4, 4), num_filter=8)
    g = sym.Deconvolution(g, name="g2", kernel=(4, 4), stride=(2, 2),
                          pad=(1, 1), num_filter=6, num_group=2,
                          no_bias=False)
    g = sym.InstanceNorm(g, name="in1")
    g = sym.LeakyReLU(g, name="pr", act_type="prelu")
    return sym.SVMOutput(sym.Flatten(g), name="svm")


def test_parameter_shapes_are_inferred_as_in_jax():
    shapes = {"rand": (2, 5, 1, 1)}
    net, jnet = _dcgan_like(mx.sym), _dcgan_like(jmx.sym)
    assert net.list_arguments() == jnet.list_arguments()
    got = net.infer_shape(**shapes)
    want = jnet.infer_shape(**shapes)
    assert [tuple(s) for s in got[0]] == [tuple(s) for s in want[0]]
    assert [tuple(s) for s in got[1]] == [tuple(s) for s in want[1]]
    exe = net.simple_bind(mx.cpu(), **shapes)
    assert exe.arg_dict["g2_weight"].shape == (8, 3, 4, 4)
    assert exe.arg_dict["svm_label"].shape == (2,)


@pytest.mark.parametrize("head", ["LinearRegressionOutput",
                                  "MAERegressionOutput",
                                  "LogisticRegressionOutput"])
def test_regression_label_takes_the_data_shape(head):
    x = mx.sym.Variable("x")
    net = getattr(mx.sym, head)(mx.sym.FullyConnected(x, num_hidden=3,
                                                      name="fc"),
                                name="out")
    args, outs, _ = net.infer_shape(x=(4, 5))
    jnet = getattr(jmx.sym, head)(jmx.sym.FullyConnected(
        jmx.sym.Variable("x"), num_hidden=3, name="fc"), name="out")
    jargs, jouts, _ = jnet.infer_shape(x=(4, 5))
    assert [tuple(a) for a in args] == [tuple(a) for a in jargs]
    assert dict(zip(net.list_arguments(), args))["out_label"] == (4, 3)


def test_rrelu_in_training_draws_slopes_from_the_generator():
    x = -np.abs(np.random.RandomState(0).normal(0, 1, (64, 32))) \
        .astype(np.float32) - 0.1
    arr = mx.nd.array(x, ctx=mx.cpu())
    outs = []
    for _ in range(2):
        mx.random.seed(5)
        with mx.autograd.record():
            outs.append(mx.nd.LeakyReLU(arr, act_type="rrelu").asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    slope = outs[0] / x
    assert slope.min() >= 0.125 - 1e-6 and slope.max() <= 0.334 + 1e-6
    assert 0.2 < slope.mean() < 0.26
    inference = mx.nd.LeakyReLU(arr, act_type="rrelu").asnumpy()
    np.testing.assert_allclose(inference / x, (0.125 + 0.334) / 2, 1e-6)


def test_update_ops_run_as_symbols():
    """``mx.sym.adam_update`` in a graph gives the JAX op's new weight;
    ``mx.nd.adam_update`` keeps its in-place behaviour."""
    rng = np.random.RandomState(1)
    w, g, m = (rng.normal(0, 1, (3, 4)).astype(np.float32)
               for _ in range(3))
    v = rng.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
    names = ("weight", "grad", "mean", "var")
    vals = dict(zip(names, (w, g, m, v)))

    def out_of(pkg, ctx):
        s = pkg.sym.adam_update(*[pkg.sym.Variable(n) for n in names],
                                lr=0.01, wd=0.001, name="upd")
        args = {k: pkg.nd.array(x, ctx=ctx) if ctx else pkg.nd.array(x)
                for k, x in vals.items()}
        exe = s.bind(ctx, args) if ctx else s.bind(pkg.cpu(), args)
        return exe.forward()[0].asnumpy()

    np.testing.assert_allclose(out_of(mx, mx.cpu()), out_of(jmx, None),
                               1e-6, 1e-7)
    arrs = [mx.nd.array(x, ctx=mx.cpu()) for x in (w, g, m, v)]
    res = mx.nd.adam_update(*arrs, lr=0.01, wd=0.001)
    assert res is arrs[0]
    np.testing.assert_allclose(arrs[0].asnumpy(), out_of(jmx, None), 1e-6,
                               1e-7)
    assert not np.array_equal(arrs[2].asnumpy(), m)


# -------------------------------------------------------------- test_utils
@pytest.mark.parametrize("op,inputs,attrs,kw", [
    ("sigmoid", [(3, 4)], {}, {}),
    ("Deconvolution", [(1, 2, 3, 3), (2, 2, 3, 3)],
     {"kernel": (3, 3), "stride": (2, 2), "num_filter": 2}, {}),
    ("InstanceNorm", [(2, 2, 3, 3), (2,), (2,)], {}, {"weighted": True}),
    ("LeakyReLU", [(3, 4)], {"act_type": "elu", "slope": 0.5}, {})])
def test_check_numeric_gradient(op, inputs, attrs, kw):
    rng = np.random.RandomState(3)
    arrays = [rng.normal(0, 1, s) for s in inputs]
    if op == "InstanceNorm":
        arrays[1] = rng.uniform(0.5, 1.5, inputs[1])
    mx.test_utils.check_numeric_gradient(op, arrays, attrs, rtol=2e-2,
                                         atol=2e-3, ctx=mx.cpu(), **kw)


def test_test_utils_default_to_the_current_context(monkeypatch):
    """``ctx=None`` in ``mx.test_utils`` is the current context (the card
    unless a ``with mx.cpu():`` is open), or ``MXNET_TEST_DEVICE``."""
    monkeypatch.delenv("MXNET_TEST_DEVICE", raising=False)
    tu = mx.test_utils
    assert tu.default_context() == mx.gpu(0) == mx.current_context()
    with mx.cpu():
        assert tu.default_context() == mx.cpu()
        assert tu.rand_ndarray((2, 3)).context == mx.cpu()
        tu.check_numeric_gradient("sigmoid", [np.zeros((2, 2))])
    monkeypatch.setenv("MXNET_TEST_DEVICE", "cpu")
    assert tu.default_context() == mx.cpu()
    assert tu.rand_ndarray((2,)).context == mx.cpu()


def _deconv_bn(pkg):
    x = pkg.sym.Variable("x")
    y = pkg.sym.Deconvolution(x, name="dc", kernel=(4, 4), stride=(2, 2),
                              pad=(1, 1), num_filter=3)
    y = pkg.sym.BatchNorm(y, name="bn", fix_gamma=False)
    return pkg.sym.LeakyReLU(y, name="act", act_type="leaky", slope=0.2)


def test_check_symbolic_forward_and_backward_against_jax():
    """The port's symbolic checkers on a Deconvolution-BatchNorm-LeakyReLU
    graph, given the JAX executor's outputs and gradients."""
    rng = np.random.RandomState(4)
    loc = {"x": rng.normal(0, 1, (2, 4, 3, 3)).astype(np.float32),
           "dc_weight": rng.normal(0, 0.3, (4, 3, 4, 4)).astype(np.float32),
           "bn_gamma": rng.uniform(0.5, 1.5, 3).astype(np.float32),
           "bn_beta": rng.normal(0, 1, 3).astype(np.float32)}
    aux = {"bn_moving_mean": np.zeros(3, np.float32),
           "bn_moving_var": np.ones(3, np.float32)}
    head = rng.normal(0, 1, (2, 3, 6, 6)).astype(np.float32)
    jsym = _deconv_bn(jmx)
    jexe = jsym.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in loc.items()},
                     args_grad={k: jmx.nd.zeros(v.shape)
                                for k, v in loc.items()},
                     aux_states={k: jmx.nd.array(v) for k, v in aux.items()})
    want_out = jexe.forward(is_train=False)[0].asnumpy()
    jexe.forward(is_train=True)
    jexe.backward([jmx.nd.array(head)])
    want_grads = {k: v.asnumpy() for k, v in jexe.grad_dict.items()}
    sym = _deconv_bn(mx)
    mx.test_utils.check_symbolic_forward(sym, loc, [want_out], rtol=1e-5,
                                         atol=1e-6, aux_states=aux,
                                         ctx=mx.cpu())
    mx.test_utils.check_symbolic_backward(sym, loc, [head], want_grads,
                                          rtol=1e-4, atol=1e-5,
                                          aux_states=aux, ctx=mx.cpu())


def test_check_consistency_across_dtypes():
    """f32 against f64 on the CPU through ``check_consistency``; a net of
    float16 would be compared at the float16 tolerance."""
    sym = _deconv_bn(mx)
    shape = {"x": (2, 4, 3, 3)}
    truth = mx.test_utils.check_consistency(
        sym, [dict(ctx=mx.cpu(), **shape),
              dict(ctx=mx.cpu(), type_dict={"x": "float64",
                                            "dc_weight": "float64",
                                            "bn_gamma": "float64",
                                            "bn_beta": "float64"}, **shape)],
        scale=0.5, tol=1e-4)
    assert set(truth) >= {"act_output", "grad:x", "grad:dc_weight"}
    # the worst |f32 - f64| / (1 + |f64|) over every comparison
    assert 0 < truth["max_err"] <= 1e-4
