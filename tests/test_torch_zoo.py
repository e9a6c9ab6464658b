"""The port's model zoo (``mxnet_tpu_torch/models``) against the JAX
package's, on the CPU.

* Every zoo name and alias spelling builds the JAX package's Symbol JSON,
  node for node, attribute for attribute.
* ``infer_shape`` at full width (batch 128, 224x224, 299x299 for
  Inception-v3) gives the JAX package's argument, output and auxiliary
  shapes.  The JAX side is the JAX package's own shape rules and ops, in
  one pass in topological order (:func:`_jax_shapes`): the JAX
  ``Symbol.infer_shape`` re-traces each hook's ancestors, which takes
  minutes on Inception-ResNet-v2.
* Forward and backward of mlp, lenet, a reduced AlexNet and a reduced
  ResNeXt, and of an ``Inception7A`` and an Inception-ResNet block built
  by both packages' block functions, through the training Executor with
  the same seeded values: the outputs within rtol 1e-5 and an atol of
  1e-6 of the array's largest entry (``test_torch_executor_train.py``'s
  bounds); each gradient and moving statistic within ``TOL_GRAD`` of its
  array's largest entry.  AlexNet's Dropout runs at rate 0 (the packages
  draw other bits).
* The block-fusion plans of both packages on Inception-v3 (NHWC,
  training): 94 blocks, 40 of them on K5, the same fallbacks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.analysis import fusion as jfusion
from mxnet_tpu.ops import shapes as jshapes
from mxnet_tpu.ops.registry import OpContext as JaxOpContext
from mxnet_tpu.symbol import _classify_vars

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.analysis import fusion as tfusion

RTOL, ATOL = 1e-5, 1e-6
#: gradients and moving statistics: max |port - JAX| over max |JAX| of the
#: array.  The deep nets' BatchNorms carry the other summation orders of
#: torch and XLA through every layer: the reduced ResNeXt reads 3.9e-5
#: (a BatchNorm's gamma), the Inception blocks 8.0e-6, AlexNet 2.2e-6
TOL_GRAD = 1e-4

ZOO = ("mlp", "lenet", "alexnet", "vgg", "resnet", "inception_bn",
       "inception_v3", "inception_resnet_v2", "googlenet", "resnext")
ALIASES = ("inception-bn", "inception-v3", "resnet-50", "resnet50",
           "resnet_18", "vgg16", "vgg19", "resnext-101-64x4d",
           "resnext-50", "inception-resnet-v2")


def _image(name):
    return "3,299,299" if name.replace("-", "_") == "inception_v3" \
        else "3,224,224"


def _build(mx, models, name, **kw):
    with mx.name.NameManager():
        return models.get_model(name, **kw)


def test_zoo_names_are_the_jax_packages():
    assert tmodels._MODELS == jmodels._MODELS == ZOO


@pytest.mark.parametrize("name", ZOO + ALIASES)
def test_tojson_matches_jax(name):
    kw = dict(num_classes=1000, image_shape=_image(name))
    want = _build(jmx, jmodels, name, **kw).tojson()
    got = _build(tmx, tmodels, name, **kw).tojson()
    assert got == want


def test_unknown_name_raises_the_jax_error():
    for mod in (jmodels, tmodels):
        with pytest.raises(ValueError, match="unknown model 'squeeze_net'"):
            mod.get_model("squeeze-net")


def _jax_shapes(net, **known):
    """Argument, output and auxiliary shapes of a JAX Symbol: each op's
    parameter-shape rule (``mxnet_tpu/ops/shapes.py``) on its known input
    shapes, then ``jax.eval_shape`` of the JAX op, node by node."""
    topo = net._topo()
    arg_nodes, aux_nodes = _classify_vars(topo)
    vals = {}
    for node in topo:
        if node.is_variable:
            if node.name in known:
                vals[id(node)] = [jax.ShapeDtypeStruct(known[node.name],
                                                       jnp.float32)]
            continue
        names = node.arg_names() + node.aux_names()
        hook = jshapes.get_param_shapes(node.op.name)
        if hook is not None:
            have = {nm: tuple(vals[id(src)][i].shape)
                    for nm, (src, i) in zip(names, node.inputs)
                    if id(src) in vals}
            for nm, shp in hook(node.attrs, have).items():
                src = node.inputs[names.index(nm)][0]
                if src.is_variable and id(src) not in vals:
                    vals[id(src)] = [jax.ShapeDtypeStruct(tuple(shp),
                                                          jnp.float32)]
        ins = [vals[id(src)][i] for src, i in node.inputs]

        def run(*xs, node=node):
            out = node.op.fcompute(node.attrs, JaxOpContext(is_train=False),
                                   *xs)
            return tuple(out) if isinstance(out, (tuple, list)) else (out,)
        vals[id(node)] = list(jax.eval_shape(run, *ins))
    heads = [tuple(vals[id(n)][i].shape) for n, i in net._entries]
    return ([tuple(vals[id(n)][0].shape) for n in arg_nodes], heads,
            [tuple(vals[id(n)][0].shape) for n in aux_nodes])


@pytest.mark.parametrize("name", ZOO)
def test_infer_shape_at_full_width_matches_jax(name):
    image = tuple(int(v) for v in _image(name).split(","))
    data = (128,) + (image if name not in ("mlp", "lenet")
                     else (1, 28, 28))
    jnet = _build(jmx, jmodels, name, num_classes=1000,
                  image_shape=_image(name))
    tnet = tmx.sym.load_json(jnet.tojson())
    got = tnet.infer_shape(data=data)
    want = _jax_shapes(jnet, data=data)
    for g, w in zip(got, want):
        assert [tuple(s) for s in g] == w
    assert got[1] == [(128, 1000)]


def _values(jnet, shapes, classes, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = jnet.infer_shape(**shapes)
    args = {}
    for n, s in zip(jnet.list_arguments(), arg_shapes):
        if n == "softmax_label":
            args[n] = rng.randint(0, classes, s).astype(np.float32)
        else:
            fan_in = max(int(np.prod(s[1:])), 1) if len(s) > 1 else 1
            scale = 1.0 if n == "data" else (2.0 / fan_in) ** 0.5
            args[n] = (rng.randn(*s) * scale).astype(np.float32)
    aux = {}
    for n, s in zip(jnet.list_auxiliary_states(), aux_shapes):
        aux[n] = (rng.rand(*s) + 0.5 if n.endswith("var")
                  else rng.randn(*s) * 0.1).astype(np.float32)
    return args, aux


def _close(got, want, msg=""):
    want = np.asarray(want.asnumpy())
    np.testing.assert_allclose(got.asnumpy(), want, RTOL,
                               ATOL * max(np.abs(want).max(), 1.0),
                               err_msg=msg)


def _inception7a(mx):
    from mxnet_tpu_torch.models import inception_v3 as tv3
    from mxnet_tpu.models import inception_v3 as jv3
    v3 = jv3 if mx is jmx else tv3
    data = mx.sym.Variable("data")
    x = v3.Inception7A(data, 8, 6, 8, 8, 6, 8, "avg", 4, "mixed")
    x = mx.sym.Pooling(x, kernel=(5, 5), global_pool=True, pool_type="avg")
    x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=5, name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def _block35(mx):
    from mxnet_tpu_torch.models import inception_resnet_v2 as tr
    from mxnet_tpu.models import inception_resnet_v2 as jr
    irv2 = jr if mx is jmx else tr
    data = mx.sym.Variable("data")
    x = irv2.block35(data, 6, scale=0.17)
    x = mx.sym.Pooling(x, kernel=(5, 5), global_pool=True, pool_type="avg")
    x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=5, name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def _resnext(mx):
    from mxnet_tpu_torch.models import resnext as tr
    from mxnet_tpu.models import resnext as jr
    return (jr if mx is jmx else tr).resnext(
        [1, 1, 1], 3, [8, 16, 32, 64], 5, 4, [3, 16, 16],
        bottle_neck=True, mid_ratio=0.5)


def _alexnet(mx):
    """AlexNet with its Dropout at rate 0: the two packages draw other
    bits (the executor tests hold Dropout to its rate instead)."""
    with jmx.name.NameManager():
        js = jmodels.get_model("alexnet", num_classes=7).tojson()
    return mx.sym.load_json(js.replace('"p": "0.5"', '"p": "0.0"'))


NETS = {
    "mlp": (lambda mx: _build(mx, jmodels if mx is jmx else tmodels, "mlp",
                              num_classes=10),
            {"data": (4, 1, 28, 28), "softmax_label": (4,)}, 10),
    "lenet": (lambda mx: _build(mx, jmodels if mx is jmx else tmodels,
                                "lenet", num_classes=10),
              {"data": (3, 1, 28, 28), "softmax_label": (3,)}, 10),
    "alexnet_67px": (_alexnet, {"data": (2, 3, 67, 67),
                                "softmax_label": (2,)}, 7),
    "resnext_reduced": (_resnext, {"data": (2, 3, 16, 16),
                                   "softmax_label": (2,)}, 5),
    "inception7a": (_inception7a, {"data": (2, 5, 9, 9),
                                   "softmax_label": (2,)}, 5),
    "block35": (_block35, {"data": (2, 6, 7, 7),
                           "softmax_label": (2,)}, 5),
}


def _scaled_err(got, want, scale=None):
    """max |got - want| over ``scale`` (default max |want|)."""
    want = np.asarray(want.asnumpy())
    scale = np.abs(want).max() if scale is None else scale
    return float(np.abs(got.asnumpy() - want).max() / max(scale, 1e-30))


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_backward_matches_jax(name):
    build, shapes, classes = NETS[name]
    with jmx.name.NameManager():
        jnet = build(jmx)
    with tmx.name.NameManager():
        tnet = build(tmx)
    assert tnet.tojson() == jnet.tojson()
    args, aux = _values(jnet, shapes, classes)
    jexe = jnet.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in args.items()},
                     aux_states={k: jmx.nd.array(v) for k, v in aux.items()})
    texe = tnet.bind(tmx.cpu(), {k: tmx.nd.array(v, ctx=tmx.cpu())
                                 for k, v in args.items()},
                     aux_states={k: tmx.nd.array(v, ctx=tmx.cpu())
                                 for k, v in aux.items()})
    for t, j in zip(texe.forward(is_train=True), jexe.forward(is_train=True)):
        _close(t, j)
    jexe.backward()
    texe.backward()
    # a convolution's bias ahead of a BatchNorm has a true gradient of 0:
    # such arrays are held against the largest gradient of the net
    top = max(np.abs(g.asnumpy()).max() for g in jexe.grad_dict.values())
    worst = {}
    for n, g in jexe.grad_dict.items():
        own = np.abs(g.asnumpy()).max()
        worst[n] = _scaled_err(texe.grad_dict[n], g,
                               own if own > TOL_GRAD * top else top)
    for n, a in jexe.aux_dict.items():
        worst[n] = _scaled_err(texe.aux_dict[n], a)
    assert max(worst.values()) <= TOL_GRAD, \
        sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_inception_v3_plan_matches_jax():
    """Inception-v3's plan: every Conv->BN->ReLU a block (the towers feed
    a Concat, the pool projections follow a Pooling: each block's output
    has one consumer), the 40 1x1 stride-1 heads on K5."""
    jnet = _build(jmx, jmodels, "inception-v3", num_classes=1000)
    tnet = tmx.sym.load_json(jnet.tojson())
    jp = jfusion.plan_block_fusion(jnet._topo(), jnet._entries,
                                   layout="NHWC", is_train=True,
                                   record=False)
    tp = tfusion.plan_block_fusion(tnet._topo(), tnet._entries,
                                   layout="NHWC", is_train=True)
    got, want = tp.summary(), jp.summary()
    for key in ("blocks", "kinds", "pallas_blocks", "relayouts_eliminated",
                "fallbacks"):
        assert got[key] == want[key], key
    assert got["blocks"] == 94 and got["pallas_blocks"] == 40
    assert sorted(b.name for b in tp.blocks.values() if b.pallas) == \
        sorted(b.name for b in jp.blocks.values() if b.pallas)
