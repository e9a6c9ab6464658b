"""The rest of ``ops/spatial.py`` and the ``Custom`` op on the CPU against
the JAX package: ``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``, ``ROIPooling`` (ties planted after a ReLU),
``Correlation`` and ``_contrib_Proposal`` through the op corpus
(``mxnet_tpu_torch/tools/op_corpus.py``, the shapes of
``tests/test_spatial_ops.py``): outputs and the gradients of ``sum(out *
cot)`` against ``jax.vjp``, within ``torch_corpus_oracle.TOL``; then
``Custom`` in a graph (forward, backward and ``infer_shape`` on ``meta``,
which must not call the user's ``forward``), imperatively, and a
``CustomOpProp`` that fills a label shape."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops.registry import OpContext, get_op
from mxnet_tpu_torch.tools import op_corpus

from torch_corpus_oracle import cases_of, check_case

# the corpus's Custom case needs its prop in the JAX package's registry too
jmx.operator.register(op_corpus.CUSTOM_OP_TYPE)(
    op_corpus.custom_affine_classes(jmx.operator)[1])

CASES = cases_of("spatial") + cases_of("operator")


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case):
    check_case(case)


def test_the_corpus_covers_the_spatial_ops_and_custom():
    assert {get_op(c.op).name for c in CASES} == {
        "GridGenerator", "BilinearSampler", "SpatialTransformer",
        "ROIPooling", "Correlation", "_contrib_Proposal", "Custom"}
    assert op_corpus.DETECTION_OPS == {get_op(c.op).name for c in
                                       CASES + cases_of("contrib")}


def test_roi_pooling_splits_a_tied_gradient_evenly():
    """A bin of equal values passes each an equal share (amax's rule and
    jnp.max's), not all of it to one index."""
    data = torch.zeros(1, 1, 4, 4, requires_grad=True)
    rois = torch.tensor([[0, 0, 0, 3, 3]], dtype=torch.float32)
    op = get_op("ROIPooling")
    out = op.fcompute(op.parse_attrs({"pooled_size": "(1, 1)"}), OpContext(),
                      data, rois)
    out.sum().backward()
    np.testing.assert_allclose(data.grad.numpy(), np.full((1, 1, 4, 4),
                                                          1 / 16))


def test_proposal_runs_on_meta():
    op = get_op("_contrib_Proposal")
    attrs = op.parse_attrs({"rpn_pre_nms_top_n": "400",
                            "rpn_post_nms_top_n": "64",
                            "scales": "(2, 4)", "ratios": "(1.0,)",
                            "feature_stride": "8", "output_score": "True"})
    rois, score = op.fcompute(attrs, OpContext(), *(
        torch.empty(s, device="meta")
        for s in ((1, 4, 12, 12), (1, 8, 12, 12), (1, 3))))
    assert rois.shape == (64, 5) and score.shape == (64, 1)
    assert rois.device.type == "meta"


# ------------------------------------------------------------- Custom
class _Sqr:
    """x^2 with its gradient 2 x dy, for either package's operator
    module; ``calls`` counts the forwards run."""

    calls = 0

    @staticmethod
    def classes(operator):
        class Sqr(operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                _Sqr.calls += 1
                self.assign(out_data[0], req[0], in_data[0].asnumpy() ** 2)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                self.assign(in_grad[0], req[0], 2 * in_data[0].asnumpy()
                            * out_grad[0].asnumpy())

        class SqrProp(operator.CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=True)

            def create_operator(self, ctx, shapes, dtypes):
                return Sqr()

        return SqrProp


class _Weighted:
    """A two-argument prop whose ``infer_shape`` gives its ``weight`` the
    data's shape: out = data * weight, rows summed."""

    @staticmethod
    def classes(operator):
        class Weighted(operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.assign(out_data[0], req[0], (
                    in_data[0].asnumpy() * in_data[1].asnumpy()).sum(1))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                g = out_grad[0].asnumpy()[:, None]
                self.assign(in_grad[0], req[0], g * in_data[1].asnumpy())
                self.assign(in_grad[1], req[1], g * in_data[0].asnumpy())

        class WeightedProp(operator.CustomOpProp):
            def list_arguments(self):
                return ["data", "weight"]

            def infer_shape(self, in_shape):
                d = in_shape[0]
                return [d, d], [[d[0]]], []

            def create_operator(self, ctx, shapes, dtypes):
                return Weighted()

        return WeightedProp


for _pkg in (jmx, mx):
    _pkg.operator.register("t_sqr")(_Sqr.classes(_pkg.operator))
    _pkg.operator.register("t_weighted")(_Weighted.classes(_pkg.operator))


def _graph(pkg):
    data = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(data, num_hidden=5, name="fc")
    h = pkg.sym.Custom(h, op_type="t_sqr", name="sqr")
    h = pkg.sym.Custom(data=h, op_type="t_weighted", name="wsum")
    return pkg.sym.MakeLoss(h, name="loss")


def _run(pkg, ctx, args):
    net = _graph(pkg)
    exe = net.bind(ctx, {k: pkg.nd.array(v, ctx=ctx)
                         for k, v in args.items()},
                   args_grad={k: pkg.nd.zeros(v.shape, ctx=ctx)
                              for k, v in args.items()})
    out = exe.forward(is_train=True)[0].asnumpy()
    exe.backward()
    return out, {k: g.asnumpy() for k, g in exe.grad_dict.items()}


def test_custom_in_a_graph_matches_jax():
    """Forward and every argument's gradient through two Custom ops (the
    second with a parameter whose shape its prop infers)."""
    net = _graph(mx)
    args, outs, _ = net.infer_shape(data=(4, 3))
    shapes = dict(zip(net.list_arguments(), args))
    assert shapes == {"data": (4, 3), "fc_weight": (5, 3), "fc_bias": (5,),
                      "wsum_weight": (4, 5)}
    assert outs == [(4,)]
    rng = np.random.RandomState(0)
    vals = {k: rng.normal(0, 1, s).astype(np.float32)
            for k, s in shapes.items()}
    calls = mx.operator.Custom.host_calls
    got, ggot = _run(mx, mx.cpu(), vals)
    assert mx.operator.Custom.host_calls - calls == 4   # 2 fwd + 2 bwd
    want, gwant = _run(jmx, jmx.cpu(), vals)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(ggot[k], gwant[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_custom_infer_shape_on_meta_does_not_run_forward():
    before = _Sqr.calls
    _, outs, _ = _graph(mx).infer_shape(data=(2, 7))
    assert outs == [(2,)] and _Sqr.calls == before


def test_custom_imperative_and_recorded():
    x = mx.nd.array(np.array([1.0, 2.0, 3.0], np.float32), ctx=mx.cpu())
    np.testing.assert_allclose(mx.nd.Custom(x, op_type="t_sqr").asnumpy(),
                               [1.0, 4.0, 9.0])
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="t_sqr")
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [2.0, 4.0, 6.0])


def test_custom_unknown_op_type_raises():
    with pytest.raises(mx.MXNetError, match="not registered"):
        mx.sym.Custom(mx.sym.Variable("x"), op_type="t_missing")
