"""ResNet's ops and the fused regions in the port against the JAX package,
forward and ``jax.vjp`` gradients, on the same numpy inputs and output
gradient, in NCHW and NHWC.

Tolerances: the ops rtol 1e-5, atol 1e-6 (f32 on the CPU, the same
arithmetic summed in other orders); the fused regions rtol 1e-4, atol 1e-5
(their backwards chain a conv's gradient behind the BN gradient's
reduction passes).  Each atol is taken relative to the tensor's largest
entry where that exceeds 1: a weight gradient sums hundreds of terms with
cancellation, so its rounding follows the size of the terms, not of the
entry.  The regions are held to the JAX regions, K5's region
(``pallas=True``) to the Pallas kernel in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import fused as jfused
from mxnet_tpu.ops.nn import image_layout as jax_image_layout
from mxnet_tpu.ops.registry import OpContext as JaxOpContext, \
    get_op as jax_get_op

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused as tfused
from mxnet_tpu_torch.ops.nn import image_layout
from mxnet_tpu_torch.ops.registry import OpContext, apply_op, get_op

OP_TOL = dict(rtol=1e-5, atol=1e-6)
REGION_TOL = dict(rtol=1e-4, atol=1e-5)


def _nhwc(a, layout):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1)) \
        if layout == "NHWC" else a


def _vjp_both(jfn, tfn, inputs, diff, seed=0):
    """Run ``jfn`` (JAX) and ``tfn`` (port) on ``inputs`` (numpy); each
    returns a tuple whose first entry is differentiated, by one random
    output gradient, with respect to the inputs indexed by ``diff``.
    Returns (port outputs, port grads, JAX outputs, JAX grads) as numpy."""
    def jhead(*xs):
        full = list(inputs)
        for i, x in zip(diff, xs):
            full[i] = x
        outs = jfn(*full)
        return outs[0], outs[1:]

    jout, vjp, jrest = jax.vjp(jhead, *[inputs[i] for i in diff],
                               has_aux=True)
    g = np.random.RandomState(seed + 100).normal(
        0, 1, np.shape(jout)).astype(np.float32)
    jgrads = vjp(g)
    ts = [None if x is None else torch.tensor(np.asarray(x))
          for x in inputs]
    for i in diff:
        ts[i].requires_grad_(True)
    outs = tfn(*ts)
    grads = torch.autograd.grad(outs[0], [ts[i] for i in diff],
                                torch.from_numpy(g), allow_unused=True)
    # an input the port does not use (fix_gamma's gamma) has no gradient;
    # JAX gives it zeros
    return ([o.detach().numpy() for o in outs],
            [np.zeros(ts[i].shape, np.float32) if x is None else x.numpy()
             for i, x in zip(diff, grads)],
            [np.asarray(jout)] + [np.asarray(o) for o in jrest],
            [np.asarray(x) for x in jgrads])


def _op_both(name, raw, inputs, diff, layout="NCHW", is_train=True):
    jop, op = jax_get_op(name), get_op(name)
    jattrs = jop.parse_attrs(raw)
    attrs = op.parse_attrs({k: str(v) for k, v in raw.items()})

    def jfn(*xs):
        out = jop.fcompute(jattrs, JaxOpContext(is_train=is_train), *xs)
        return out if isinstance(out, tuple) else (out,)

    def tfn(*xs):
        return apply_op(op, attrs, OpContext(is_train=is_train), *xs)

    with jax_image_layout(layout), image_layout(layout):
        return _vjp_both(jfn, tfn, inputs, diff)


def _close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=6,
         no_bias=False),
    dict(kernel=(1, 1), num_filter=6, no_bias=True),
    dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 2), num_group=2,
         num_filter=6, no_bias=True),
    dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=6,
         no_bias=True),
], ids=["3x3s2-bias", "1x1", "dilated-grouped", "7x7s2"])
def test_convolution_matches_jax(case, layout):
    rng = np.random.RandomState(0)
    groups = case.get("num_group", 1)
    x = rng.normal(0, 1, (2, 4, 11, 11)).astype(np.float32)
    w = rng.normal(0, 0.3, (6, 4 // groups) + case["kernel"]) \
        .astype(np.float32)
    inputs = [_nhwc(x, layout), w]
    if not case["no_bias"]:
        inputs.append(rng.normal(0, 1, (6,)).astype(np.float32))
    outs, grads, jouts, jgrads = _op_both(
        "Convolution", case, inputs, tuple(range(len(inputs))), layout)
    _close(outs, jouts, OP_TOL)
    _close(grads, jgrads, OP_TOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         pooling_convention="full"),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="sum"),
    dict(kernel=(7, 7), global_pool=True, pool_type="avg"),
], ids=["max", "max-full", "avg-full", "sum", "global-avg"])
def test_pooling_matches_jax(case, layout):
    x = np.random.RandomState(1).normal(0, 1, (2, 3, 10, 10)) \
        .astype(np.float32)
    outs, grads, jouts, jgrads = _op_both("Pooling", case, [_nhwc(x, layout)],
                                          (0,), layout)
    _close(outs, jouts, OP_TOL)
    _close(grads, jgrads, OP_TOL)


def _bn_inputs(layout, c=5, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.normal(0.7, 2, (4, c, 6, 6)).astype(np.float32)
    return [_nhwc(x, layout),
            rng.uniform(0.5, 1.5, (c,)).astype(np.float32),
            rng.normal(0, 1, (c,)).astype(np.float32),
            rng.normal(0.5, 0.2, (c,)).astype(np.float32),
            rng.uniform(0.5, 2.0, (c,)).astype(np.float32)]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", [
    dict(fix_gamma=False, eps=2e-5, momentum=0.9),
    dict(fix_gamma=True),
    dict(fix_gamma=False, use_global_stats=True),
    dict(fix_gamma=False, output_mean_var=True),
], ids=["train", "fix-gamma", "global-stats", "mean-var"])
def test_batch_norm_matches_jax(case, layout):
    """Output, the aux outputs (new moving mean and variance) and the
    gradients of data, gamma and beta."""
    outs, grads, jouts, jgrads = _op_both(
        "BatchNorm", case, _bn_inputs(layout), (0, 1, 2), layout)
    assert len(outs) == (5 if case.get("output_mean_var") else 3)
    _close(outs, jouts, OP_TOL)
    _close(grads, jgrads, OP_TOL)
    if case.get("fix_gamma"):
        assert not grads[1].any()


def test_batch_norm_inference_moves_no_statistics():
    op = get_op("BatchNorm")
    x, gamma, beta, mm, mv = (torch.from_numpy(a) for a in
                              _bn_inputs("NCHW"))
    out, new_mm, new_mv = apply_op(op, op.parse_attrs({}), OpContext(),
                                   x, gamma, beta, mm, mv)
    assert torch.equal(new_mm, mm) and torch.equal(new_mv, mv)


def test_image_layout_refuses_other_layouts():
    with pytest.raises(MXNetError):
        image_layout("NCWH")


def test_convolution_pinned_to_nchw_refuses_nhwc_mode():
    op = get_op("Convolution")
    attrs = op.parse_attrs({"kernel": "(1, 1)", "num_filter": "2",
                            "no_bias": "True", "layout": "NCHW"})
    with image_layout("NHWC"), pytest.raises(MXNetError, match="pins"):
        op.fcompute(attrs, OpContext(), torch.zeros(1, 2, 2, 3),
                    torch.zeros(2, 3, 1, 1))


# ------------------------------------------------------------ regions
def _region_both(jcall, tcall, inputs, diff):
    """Fused regions: outputs (out, new_mm, new_mv) and the gradients of
    the inputs indexed by ``diff`` against a random gradient of ``out``."""
    return _vjp_both(lambda *xs: tuple(jcall(*xs)),
                     lambda *xs: tuple(tcall(*xs)), inputs, diff, seed=3)


def _conv_bn_case(layout, kernel, bias, n_out=128, seed=4):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (2, 16, 5, 5)).astype(np.float32)
    w = rng.normal(0, 0.25, (n_out, 16) + kernel).astype(np.float32)
    b = rng.normal(0, 1, (n_out,)).astype(np.float32) if bias else None
    _x, gamma, beta, mm, mv = _bn_inputs(layout, c=n_out, seed=seed)
    return [_nhwc(x, layout), w, b, gamma, beta, mm, mv]


def _attrs(name, raw):
    jattrs = jax_get_op(name).parse_attrs(raw)
    attrs = get_op(name).parse_attrs({k: str(v) for k, v in raw.items()})
    return jattrs, attrs


@pytest.mark.parametrize("case", [
    # the K5 route (the Pallas kernel in interpret mode on the JAX side)
    dict(layout="NHWC", kernel=(1, 1), pallas=True, act="relu"),
    dict(layout="NHWC", kernel=(1, 1), pallas=True, act=None),
    # the general route
    dict(layout="NHWC", kernel=(3, 3), pallas=False, act="relu"),
    dict(layout="NCHW", kernel=(3, 3), pallas=False, act="relu"),
    dict(layout="NHWC", kernel=(1, 1), pallas=False, act=None, bias=True),
    dict(layout="NHWC", kernel=(3, 3), pallas=False, act="relu",
         is_train=False),
    dict(layout="NCHW", kernel=(1, 1), pallas=True, act="relu",
         fix_gamma=True),
], ids=["k5-relu", "k5", "nhwc-3x3-relu", "nchw-3x3-relu", "nhwc-bias",
        "nhwc-eval", "nchw-pallas-falls-back"])
def test_fused_conv_bn_act_matches_jax(case):
    layout, bias = case["layout"], case.get("bias", False)
    conv_raw = {"kernel": case["kernel"], "num_filter": 128,
                "no_bias": not bias,
                "pad": tuple(k // 2 for k in case["kernel"])}
    bn_raw = {"fix_gamma": case.get("fix_gamma", False), "eps": 2e-5}
    jconv, tconv = _attrs("Convolution", conv_raw)
    jbn, tbn = _attrs("BatchNorm", bn_raw)
    is_train = case.get("is_train", True)
    inputs = _conv_bn_case(layout, case["kernel"], bias)
    diff = (0, 1, 2, 3, 4) if bias else (0, 1, 3, 4)

    def jcall(x, w, b, gamma, beta, mm, mv):
        return jfused.fused_block_conv_bn_act(
            jconv, jbn, layout, is_train, case["act"], case["pallas"],
            x, w, b, gamma, beta, mm, mv, interpret=True)

    def tcall(x, w, b, gamma, beta, mm, mv):
        return tfused.fused_block_conv_bn_act(
            tconv, tbn, layout, is_train, case["act"], case["pallas"],
            x, w, b, gamma, beta, mm, mv)

    outs, grads, jouts, jgrads = _region_both(jcall, tcall, inputs, diff)
    _close(outs, jouts, REGION_TOL)
    if bias:
        # a per-channel shift before a training BN is removed by its mean:
        # the bias's true gradient is 0, and both packages give rounding
        # noise of the size of the terms of dbeta's sum
        bound = 1e-4 * np.abs(jgrads[-1]).max()
        assert np.abs(grads.pop(2)).max() <= bound
        assert np.abs(jgrads.pop(2)).max() <= bound
    _close(grads, jgrads, REGION_TOL)


def test_k5_region_launches_no_kernel_on_the_cpu():
    inputs = [torch.tensor(a) if a is not None else None
              for a in _conv_bn_case("NHWC", (1, 1), False)]
    _jconv, tconv = _attrs("Convolution", {"kernel": (1, 1),
                                           "num_filter": 128,
                                           "no_bias": True})
    _jbn, tbn = _attrs("BatchNorm", {"fix_gamma": False})
    before = tfused.matmul_stats.launches
    out, _mm, _mv = tfused.fused_block_conv_bn_act(
        tconv, tbn, "NHWC", True, "relu", True, *inputs)
    assert out.shape == (2, 5, 5, 128)
    assert tfused.matmul_stats.launches == before


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("is_train", [True, False])
def test_fused_bn_act_matches_jax(layout, is_train):
    jbn, tbn = _attrs("BatchNorm", {"fix_gamma": False, "eps": 2e-5})
    ch = 3 if layout == "NHWC" else 1

    def jcall(x, gamma, beta, mm, mv):
        return jfused.fused_block_bn_act(jbn, ch, is_train, "relu", x,
                                         gamma, beta, mm, mv)

    def tcall(x, gamma, beta, mm, mv):
        return tfused.fused_block_bn_act(tbn, ch, is_train, "relu", x,
                                         gamma, beta, mm, mv)

    outs, grads, jouts, jgrads = _region_both(
        jcall, tcall, _bn_inputs(layout), (0, 1, 2))
    _close(outs, jouts, REGION_TOL)
    _close(grads, jgrads, REGION_TOL)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh"])
@pytest.mark.parametrize("flatten,bias", [(True, True), (False, False)])
def test_fused_fc_act_matches_jax(act, flatten, bias):
    rng = np.random.RandomState(5)
    x = rng.normal(0, 1, (3, 4, 5)).astype(np.float32)
    k = 20 if flatten else 5
    inputs = [x, rng.normal(0, 0.3, (7, k)).astype(np.float32),
              rng.normal(0, 1, (7,)).astype(np.float32) if bias else None]
    raw = {"num_hidden": 7, "flatten": flatten, "no_bias": not bias}
    jfc, tfc = _attrs("FullyConnected", raw)
    outs, grads, jouts, jgrads = _region_both(
        lambda x, w, b: (jfused.fused_block_fc_act(jfc, act, x, w, b),),
        lambda x, w, b: (tfused.fused_block_fc_act(tfc, act, x, w, b),),
        inputs, (0, 1, 2) if bias else (0, 1))
    _close(outs, jouts, REGION_TOL)
    _close(grads, jgrads, REGION_TOL)
