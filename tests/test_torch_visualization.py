"""``visualization``, ``registry`` and the torch bridge of the port against
the JAX package's, on the CPU: ``print_summary``'s text for the zoo's
ResNet-18 and MLP, ``plot_network``'s graphviz gate, ``registry.create``
from a ``json.dumps([name, kwargs])`` string, and ``TorchModule`` /
``TorchCriterion`` / ``mx.th`` against the JAX bridge on the same
``torch.nn`` objects."""
import contextlib
import io
import json

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)
import torch
import torch.nn as tnn

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx


def _summary(pkg, net, shape):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        total = pkg.visualization.print_summary(net, shape=shape)
    return buf.getvalue(), total


@pytest.mark.parametrize("name,kwargs,shape", [
    ("resnet", {"num_layers": 18, "num_classes": 10,
                "image_shape": "3,32,32"}, (2, 3, 32, 32)),
    ("mlp", {"num_classes": 10}, (2, 784)),
])
def test_print_summary_text_equals_jax(name, kwargs, shape):
    from mxnet_tpu import models as jmodels
    from mxnet_tpu_torch import models as tmodels
    with mx.name.NameManager():
        jnet = jmodels.get_model(name, **kwargs)
    with tmx.name.NameManager():
        tnet = tmodels.get_model(name, **kwargs)
    assert json.loads(tnet.tojson()) == json.loads(jnet.tojson())
    want, jtotal = _summary(mx, jnet, {"data": shape})
    got, ttotal = _summary(tmx, tnet, {"data": shape})
    assert got == want and ttotal == jtotal > 0
    assert _summary(tmx, tnet, None)[0] == _summary(mx, jnet, None)[0]


def test_plot_network_is_gated_on_graphviz():
    net = tmx.models.get_model("mlp", num_classes=10)
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="graphviz"):
            tmx.viz.plot_network(net)
        with pytest.raises(ImportError, match="graphviz"):
            mx.viz.plot_network(mx.models.get_model("mlp", num_classes=10))
    else:
        dot = tmx.viz.plot_network(net, shape={"data": (1, 784)})
        assert "fc1" in dot.source


@pytest.mark.parametrize("spec", [
    "gauss", json.dumps(["gauss", {"sigma": 2.5, "mu": -1}]),
    json.dumps(["Gauss", {}])])
def test_registry_create_from_json_equals_jax(spec):
    made = []
    for reg in (mx.registry, tmx.registry):
        class Base:
            pass

        @reg.get_register_func(Base, "thing")
        class Gauss(Base):
            def __init__(self, mu=0.0, sigma=1.0):
                self.mu, self.sigma = mu, sigma

        reg.get_alias_func(Base, "thing")("normal")(Gauss)
        create = reg.get_create_func(Base, "thing")
        obj = create(spec)
        assert create(obj) is obj and isinstance(create("normal"), Gauss)
        with pytest.raises(Exception, match="not registered"):
            create("nope")
        made.append(vars(obj))
    assert made[0] == made[1]


def _bind(pkg, net, ctx, shapes):
    return net.simple_bind(ctx, grad_req="write", **shapes)


def test_torch_module_forward_and_gradients_equal_the_jax_bridge():
    torch.manual_seed(0)
    lin = tnn.Linear(8, 4)
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    head = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    out = []
    for pkg, ctx in ((mx, mx.cpu()), (tmx, tmx.cpu())):
        data = pkg.sym.Variable("data")
        net = pkg.sym.TorchModule(data, module=lin, name="tmod")
        ex = _bind(pkg, net, ctx, {"data": (3, 8)})
        args = dict(zip(net.list_arguments(), ex.arg_arrays))
        for i, p in enumerate(lin.parameters()):
            args["tmod_torch_param_%d_weight" % i][:] = \
                p.detach().numpy()
        ex.forward(is_train=True, data=x)
        ex.backward([pkg.nd.array(head, ctx=ctx)])
        grads = dict(zip(net.list_arguments(), ex.grad_arrays))
        out.append((ex.outputs[0].asnumpy(),
                     {k: g.asnumpy() for k, g in grads.items()},
                     net.list_arguments()))
    (jo, jg, jn), (to, tg, tn) = out
    assert tn == jn
    np.testing.assert_allclose(to, jo, atol=1e-6)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], atol=1e-6, err_msg=k)
    want = lin(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(to, want, atol=1e-6)


def test_torch_criterion_equals_the_jax_bridge():
    crit = tnn.CrossEntropyLoss()
    x = np.random.RandomState(2).randn(4, 5).astype(np.float32)
    y = np.array([0, 3, 1, 4], np.float32)
    out = []
    for pkg, ctx in ((mx, mx.cpu()), (tmx, tmx.cpu())):
        net = pkg.sym.TorchCriterion(pkg.sym.Variable("data"),
                                     pkg.sym.Variable("label"),
                                     criterion=crit, name="loss")
        ex = _bind(pkg, net, ctx, {"data": (4, 5), "label": (4,)})
        ex.forward(is_train=True, data=x, label=y)
        ex.backward([pkg.nd.ones((4,), ctx=ctx)])
        out.append((ex.outputs[0].asnumpy(),
                    [g.asnumpy() for g in ex.grad_arrays]))
    np.testing.assert_allclose(out[1][0], out[0][0], atol=1e-6)
    for a, b in zip(out[1][1], out[0][1]):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_th_functions_run_on_the_tensors_device():
    a = np.array([[1.0, 4.0], [9.0, 16.0]], np.float32)
    tx = tmx.nd.array(a, ctx=tmx.cpu())
    jx = mx.nd.array(a)
    for fn in ("sqrt", "exp", "sigmoid"):
        np.testing.assert_allclose(getattr(tmx.th, fn)(tx).asnumpy(),
                                   getattr(mx.th, fn)(jx).asnumpy(),
                                   rtol=1e-6)
    np.testing.assert_allclose(tmx.th.mm(tx, tx).asnumpy(),
                               mx.th.mm(jx, jx).asnumpy())
    vals, idx = tmx.th.topk(tx.reshape((4,)), 2)
    assert vals.data.device == tx.data.device
    assert vals.asnumpy().tolist() == [16.0, 9.0]
