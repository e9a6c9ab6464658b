"""The port's block-fusion planner against the JAX package's greedy plan on
the same Symbol JSON: the same blocks (kind, terminal and member nodes,
activation, K5 route) and the same fallbacks.  ResNet-50 v2 at NHWC in
training is the slice's path: 50 blocks, 16 of them on K5."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.analysis import fusion as jfusion

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.analysis import fusion as tfusion
from mxnet_tpu_torch.ops.fused import block_fusion
from mxnet_tpu_torch.symbol import eval_graph


def _resnet(pkg, **kw):
    mx, models = (jmx, jmodels) if pkg == "jax" else (tmx, tmodels)
    with mx.name.NameManager():
        return models.get_model("resnet50", num_classes=1000,
                                image_shape="3,224,224", **kw)


def _odd_graph():
    """Fallbacks and fc_act, built by the JAX package: a BN over axis 2, a
    BN asking for its mean and var, a conv feeding two consumers, an
    FC->tanh and an FC->softrelu (not fusable)."""
    mx = jmx
    with mx.name.NameManager():
        x = mx.sym.Variable("data")
        c = mx.sym.Convolution(x, kernel=(1, 1), num_filter=4, name="c0")
        a = mx.sym.BatchNorm(c, name="bn_a")
        b = mx.sym.Activation(mx.sym.BatchNorm(c, name="bn_b"),
                              act_type="relu", name="r_b")
        s = a + b
        s = mx.sym.Activation(mx.sym.BatchNorm(s, axis=2, name="bn_ax"),
                              act_type="relu", name="r_ax")
        m = mx.sym.BatchNorm(s, output_mean_var=True, name="bn_mv")
        f = mx.sym.FullyConnected(m[0], num_hidden=8, name="fc_t")
        f = mx.sym.Activation(f, act_type="tanh", name="tanh")
        g = mx.sym.FullyConnected(f, num_hidden=8, name="fc_s")
        g = mx.sym.Activation(g, act_type="softrelu", name="soft")
        return mx.sym.Group([g, m[1]])


def _blocks(plan):
    def name(n):
        return None if n is None else n.name
    return sorted((b.kind, b.name, name(b.conv), name(b.bn), name(b.fc),
                   b.act, b.pallas) for b in plan.blocks.values())


def _plans(jnet, tnet, layout, is_train):
    jp = jfusion.plan_block_fusion(jnet._topo(), jnet._entries,
                                   layout=layout, is_train=is_train,
                                   record=False)
    tp = tfusion.plan_block_fusion(tnet._topo(), tnet._entries,
                                   layout=layout, is_train=is_train)
    return jp, tp


@pytest.mark.parametrize("layout,is_train,pallas", [
    ("NHWC", True, 16), ("NHWC", False, 0), ("NCHW", True, 0)])
@pytest.mark.parametrize("version", [2, 1])
def test_resnet50_plan_matches_jax(version, layout, is_train, pallas):
    jnet = _resnet("jax", version=version)
    tnet = tmx.sym.load_json(jnet.tojson())
    jp, tp = _plans(jnet, tnet, layout, is_train)
    assert _blocks(tp) == _blocks(jp)
    assert tp.fallbacks == jp.fallbacks
    assert tp.skip and len(tp.skip) == len(jp.skip)
    summary = tp.summary()
    want = jp.summary()
    for key in ("blocks", "kinds", "pallas_blocks", "relayouts_eliminated",
                "fallbacks"):
        assert summary[key] == want[key], key
    if version == 2:
        assert summary["blocks"] == 50
        assert summary["pallas_blocks"] == pallas
    assert tfusion.last_plan_summary() == summary


def test_port_resnet50_symbol_writes_the_jax_json():
    assert _resnet("port").tojson() == _resnet("jax").tojson()


def test_fallbacks_and_fc_blocks_match_jax():
    jnet = _odd_graph()
    tnet = tmx.sym.load_json(jnet.tojson())
    jp, tp = _plans(jnet, tnet, "NCHW", True)
    assert _blocks(tp) == _blocks(jp)
    assert sorted(tp.fallbacks) == sorted(jp.fallbacks)
    reasons = {r for _n, r in tp.fallbacks}
    assert {"bn_axis", "bn_output_mean_var",
            "conv_multi_consumer"} <= reasons
    assert ("fc_act", "tanh") in {(b.kind, b.name)
                                  for b in tp.blocks.values()}


def test_fused_eval_graph_equals_unfused_and_threads_every_aux():
    """A small NHWC ResNet in training, with and without the plan: the
    same heads, and a new value for every moving statistic."""
    net = tmodels.resnet.resnet(units=[1, 1], num_stages=2,
                                filter_list=[8, 32, 64], num_classes=5,
                                image_shape=[3, 16, 16])
    topo = net._topo()
    rng = np.random.RandomState(0)
    from mxnet_tpu_torch.ops.nn import image_layout
    with image_layout("NHWC"):
        arg_shapes, _, aux_shapes = net.infer_shape(data=(2, 16, 16, 3),
                                                    softmax_label=(2,))
    values = {}
    args = dict(zip(net.list_arguments(), arg_shapes))
    auxs = dict(zip(net.list_auxiliary_states(), aux_shapes))
    for node in topo:
        if not node.is_variable:
            continue
        shape = args.get(node.name, auxs.get(node.name))
        arr = rng.uniform(0.5, 1.5, shape) if node.name in auxs \
            else rng.normal(0, 0.3, shape)
        if node.name == "softmax_label":
            arr = rng.randint(0, 5, shape)
        values[id(node)] = torch.tensor(arr, dtype=torch.float32)
    out = {}
    for fuse in (False, True):
        with image_layout("NHWC"), block_fusion(fuse):
            out[fuse] = eval_graph(topo, net._entries, values, is_train=True)
    (h0, a0), (h1, a1) = out[False], out[True]
    torch.testing.assert_close(h1[0], h0[0], rtol=1e-5, atol=1e-6)
    assert set(a0) == set(a1) and len(a1) == len(auxs)
    for k in a0:
        torch.testing.assert_close(a1[k], a0[k], rtol=1e-5, atol=1e-6)
