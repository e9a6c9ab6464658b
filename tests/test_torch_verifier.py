"""The port's graph verifier (``mxnet_tpu_torch.analysis``) against the JAX
package's on the CPU: the catalogue of broken graphs of
``tests/test_analysis.py`` (MXG001 to MXG009) gives equal reports, compared
by rule, severity, node and op; ``infer_node_shapes`` agrees node by node
on ResNet-50, Inception-v3 and the GPT symbol; ``verify_model`` agrees on
every zoo network; strict binds and ``ShardedTrainer(strict=True)`` refuse
a broken graph before any op runs; the CLI's JSON document matches."""
import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)

import mxnet_tpu as jmx
import mxnet_tpu.symbol as jsym
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.symbol as tsym
from mxnet_tpu import analysis as janalysis, models as jmodels
from mxnet_tpu.ops import registry as jregistry
from mxnet_tpu_torch import analysis as tanalysis, models as tmodels
from mxnet_tpu_torch.ops import registry as tregistry
from mxnet_tpu_torch.models import gpt as tgpt
from mxnet_tpu_torch.ops import flash_attention as tflash

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "transformer"))
import train_lm  # noqa: E402  (the JAX GPT symbol)


def _key(report):
    return [(d.rule, d.severity, d.node, d.op) for d in report]


@pytest.fixture(scope="module", autouse=True)
def _drop_test_op():
    """Take ``_test_noshaperule`` out of each registry this module put it
    in, so later test files on the same worker see the registries as
    shipped."""
    had = [r._OP_REGISTRY.get("_test_noshaperule")
           for r in (jregistry, tregistry)]
    yield
    for r, before in zip((jregistry, tregistry), had):
        if before is None:
            r._OP_REGISTRY.pop("_test_noshaperule", None)


def _noshaperule(sym, registry):
    if not registry.has_op("_test_noshaperule"):
        @registry.register("_test_noshaperule", arg_names=("data", "gain"))
        def _gain(attrs, ctx, data, gain):
            return data * gain


def _shape_mismatch(sym):
    w = sym.var("w", shape=(5, 999))
    fc = sym.FullyConnected(sym.var("data"), weight=w, num_hidden=5,
                            name="fc_bad")
    return fc, {"data": (4, 10)}


def _missing_rule(sym):
    return sym._create("_test_noshaperule", "g0", None, [sym.var("data")],
                       {}), {"data": (2, 3)}


def _rule_given(sym):
    return sym._create("_test_noshaperule", "g1", None,
                       [sym.var("data"), sym.var("gain", shape=(3,))],
                       {}), {"data": (2, 3)}


def _dtype_conflict(sym):
    a = sym.var("a", dtype="float32")
    b = sym.var("b", dtype="float64")
    return sym.elemwise_add(a, b, name="mixed_add"), {"a": (2, 2),
                                                      "b": (2, 2)}


def _bf16_conflict(sym):
    a = sym.var("a", dtype="bfloat16")
    b = sym.var("b", dtype="float32")
    return sym.elemwise_add(a, b, name="bf16_add"), {"a": (2, 2),
                                                     "b": (2, 2)}


def _dead_input(sym):
    net = sym.FullyConnected(sym.var("data"), num_hidden=4, name="fc1")
    return sym.Group([net, sym.var("dead_in")]), {"data": (2, 8),
                                                  "dead_in": (1,)}


def _cycle(sym):
    x = sym.var("data")
    f1 = sym.FullyConnected(x, num_hidden=4, name="c1")
    f2 = sym.FullyConnected(f1, num_hidden=4, name="c2")
    f1._entries[0][0].inputs[0] = (f2._entries[0][0], 0)
    return f2, None


def _duplicates(sym):
    p = sym.FullyConnected(sym.var("data"), num_hidden=4, name="samename")
    return sym.FullyConnected(p, num_hidden=4, name="samename"), \
        {"data": (2, 4)}


def _underdetermined(sym):
    return sym._create("_test_noshaperule", "gp", None, [sym.var("data")],
                       {}), {"data": (2, 3)}


def _deferred_batch(sym):
    z = sym.zeros((0, 4), name="z0")
    return sym.Activation(z, act_type="relu", name="r0"), {}


def _reshape_reject(sym):
    return sym.Reshape(sym.var("data"), shape=(7, 3), name="rs"), \
        {"data": (4, 5)}


def _clean_lenet(sym):
    models = jmodels if sym is jsym else tmodels
    return models.get_model("lenet", num_classes=10), \
        {"data": (2, 1, 28, 28), "softmax_label": (2,)}


CATALOGUE = [_shape_mismatch, _missing_rule, _rule_given, _dtype_conflict,
             _bf16_conflict, _dead_input, _cycle, _duplicates,
             _underdetermined, _deferred_batch, _reshape_reject,
             _clean_lenet]


@pytest.mark.parametrize("case", CATALOGUE, ids=lambda f: f.__name__[1:])
def test_catalogue_reports_equal(case):
    reports = []
    for sym, registry in ((jsym, jregistry), (tsym, tregistry)):
        _noshaperule(sym, registry)
        net, shapes = case(sym)
        reports.append(net.verify(**(shapes or {})))
    jrep, trep = reports
    assert _key(trep) == _key(jrep), (str(jrep), str(trep))
    assert trep.ok == jrep.ok
    if case in (_dtype_conflict, _bf16_conflict):
        assert trep.diagnostics[0].message == jrep.diagnostics[0].message


@pytest.mark.parametrize("tp_case", ["tiny", "replicate", "big"])
def test_tp_coverage_equal(tp_case):
    out = []
    for sym in (jsym, tsym):
        d = sym.var("data")
        hidden = 64 if tp_case == "big" else 6
        fc = sym.FullyConnected(d, num_hidden=hidden, name="%s_fc" % tp_case)
        if tp_case == "replicate":
            fc._set_attr(__tp__="replicate")
        rep = fc.verify(data=(2, 64), tp_size=4)
        out.append((_key(rep), [d.message for d in rep]))
    assert out[0] == out[1]
    assert (tp_case == "tiny") == bool(out[1][0])


def test_json_reports_equal():
    for sym, an in ((jsym, janalysis), (tsym, tanalysis)):
        assert _key(an.verify_json("{not json")) == [
            ("MXG005", "error", None, None)]
        assert _key(an.verify_json('{"nodes": "oops", "heads": []}')) == [
            ("MXG005", "error", None, None)]
    reps = []
    for sym, an in ((jsym, janalysis), (tsym, tanalysis)):
        net = sym.FullyConnected(sym.var("data"), num_hidden=4, name="fc1")
        js = json.loads(net.tojson())
        js["nodes"].append({"op": "null", "name": "ghost", "inputs": []})
        reps.append(an.verify_json(json.dumps(js), shapes={"data": (2, 8)}))
    assert _key(reps[0]) == _key(reps[1]) == [
        ("MXG003", "warning", "ghost", None)]


def test_registry_selfcheck_and_drift():
    assert tanalysis.registry_selfcheck() == [] == \
        janalysis.registry_selfcheck()
    from mxnet_tpu_torch.ops import shapes as tshapes
    tshapes._PARAM_SHAPE_HOOKS["_no_such_op_xyz"] = lambda a, k: {}
    try:
        problems = tanalysis.registry_selfcheck()
        rep = tanalysis.verify_symbol(tsym.var("x"), check_registry=True)
    finally:
        del tshapes._PARAM_SHAPE_HOOKS["_no_such_op_xyz"]
    assert any("_no_such_op_xyz" in p for p in problems)
    assert [d.rule for d in rep.errors] == ["MXG008"]


def _node_shapes(an, net, shapes):
    """(name, shapes) in topo order, the digits of auto-generated names
    blanked (each package counts its own)."""
    topo, out = an.infer_node_shapes(net, shapes)
    return [(re.sub(r"\d+", "#", n.name), out[id(n)]) for n in topo
            if id(n) in out]


@pytest.mark.parametrize("which", ["resnet50", "inception_v3", "gpt"])
def test_infer_node_shapes_equal(which):
    got = []
    for sym, models, an in ((jsym, jmodels, janalysis),
                            (tsym, tmodels, tanalysis)):
        if which == "resnet50":
            net = models.get_model("resnet", num_classes=1000,
                                   num_layers=50)
            shapes = {"data": (2, 3, 224, 224), "softmax_label": (2,)}
        elif which == "inception_v3":
            net = models.get_model("inception_v3", num_classes=1000)
            shapes = {"data": (2, 3, 299, 299), "softmax_label": (2,)}
        else:
            build = train_lm if sym is jsym else tgpt
            net = build.gpt_symbol(512, 64, 64, 4, 2, dropout=0.0)
            shapes = {"data": (2, 64), "softmax_label": (2, 64)}
        got.append(_node_shapes(an, net, shapes))
    assert got[0] == got[1]
    assert len(got[1]) > 30


@pytest.mark.parametrize("name", list(tmodels._MODELS))
def test_verify_model_equal_on_the_zoo(name):
    _jn, jrep = janalysis.verify_model(name)
    _tn, trep = tanalysis.verify_model(name)
    assert _key(trep) == _key(jrep) == []


def test_meta_tensors_take_the_plain_kernels():
    """The shape pass runs the flash op on ``meta`` tensors: the plain
    path, no launch counted."""
    before = tflash.flash_attention_fwd.launches
    q = tsym.var("q")
    att = tsym._contrib_FlashAttention(q, q, q, causal=True, name="att")
    rep = att.verify(q=(2, 128, 4, 16))
    assert rep.ok and not rep.warnings
    _topo, shapes = tanalysis.infer_node_shapes(att, {"q": (2, 128, 4, 16)})
    assert (2, 128, 4, 16) in [s[0] for s in shapes.values()]
    assert tflash.flash_attention_fwd.launches == before


def _broken_fc(sym):
    d = sym.var("data")
    w = sym.var("w", shape=(5, 999))
    return sym.FullyConnected(d, weight=w, num_hidden=5, name="fcx")


def test_bind_strict_raises_before_any_op(monkeypatch):
    fc = _broken_fc(tsym)
    args = {"data": tmx.nd.zeros((4, 10), ctx=tmx.cpu()),
            "w": tmx.nd.zeros((5, 999), ctx=tmx.cpu()),
            "fcx_bias": tmx.nd.zeros((5,), ctx=tmx.cpu())}
    ran = []
    orig = tregistry.apply_op
    monkeypatch.setattr("mxnet_tpu_torch.symbol.apply_op",
                        lambda *a, **k: ran.append(1) or orig(*a, **k))
    with pytest.raises(tmx.MXNetError, match="MXG005.*fcx"):
        fc.bind(tmx.cpu(), args, strict=True)
    assert ran == []
    # without strict the failure waits for the forward
    exe = fc.bind(tmx.cpu(), args)
    with pytest.raises(Exception):
        exe.forward()
    monkeypatch.setenv("MXNET_TPU_STRICT_BIND", "1")
    with pytest.raises(tmx.MXNetError, match="fcx"):
        fc.bind(tmx.cpu(), args)
    ok = tsym.FullyConnected(tsym.var("data"), num_hidden=4, name="fc1")
    exe = ok.simple_bind(tmx.cpu(), data=(2, 8), strict=True)
    assert exe.forward()[0].shape == (2, 4)


def test_trainer_strict_refuses_a_broken_graph(monkeypatch):
    from mxnet_tpu_torch.parallel import ShardedTrainer, build_mesh
    bad = tsym.SoftmaxOutput(_broken_fc(tsym), name="softmax")
    allocated = []
    monkeypatch.setattr("mxnet_tpu_torch.parallel.trainer.Xavier",
                        lambda *a, **k: allocated.append(1))
    with pytest.raises(tmx.MXNetError, match="MXG005.*fcx"):
        ShardedTrainer(bad, build_mesh(devices=[tmx.cpu()]),
                       data_shapes={"data": (4, 10)},
                       label_shapes={"softmax_label": (4,)}, strict=True)
    assert allocated == []
    monkeypatch.setenv("MXNET_TPU_STRICT_BIND", "1")
    with pytest.raises(tmx.MXNetError, match="MXG005"):
        ShardedTrainer(bad, build_mesh(devices=[tmx.cpu()]),
                       data_shapes={"data": (4, 10)},
                       label_shapes={"softmax_label": (4,)})


def test_trainer_strict_losses_equal_non_strict():
    from mxnet_tpu_torch.parallel import ShardedTrainer, build_mesh
    net = tmodels.get_model("mlp", num_classes=10)
    rng = np.random.RandomState(0)
    batch = {"data": rng.rand(8, 64).astype(np.float32),
             "softmax_label": rng.randint(0, 10, 8).astype(np.float32)}
    losses = []
    for strict in (False, True):
        tr = ShardedTrainer(net, build_mesh(devices=[tmx.cpu()]),
                            data_shapes={"data": (8, 64)},
                            label_shapes={"softmax_label": (8,)},
                            strict=strict)
        losses.append([float(tr.step(batch)) for _ in range(2)])
    assert losses[0] == losses[1]


def test_mesh_and_plan_raise_naming_their_items(tmp_path, monkeypatch):
    net = tsym.FullyConnected(tsym.var("data"), num_hidden=4, name="fc1")
    with pytest.raises(tmx.MXNetError, match="item 4"):
        tanalysis.verify_symbol(net, {"data": (2, 8)},
                                mesh={"data": 2, "model": 2})
    assert tanalysis.verify_symbol(net, {"data": (2, 8)},
                                   mesh={"data": 1}).ok
    from mxnet_tpu_torch.analysis.__main__ import main
    with pytest.raises(tmx.MXNetError, match="not yet ported"):
        main(["--model", "mlp", "--mesh", "data=2"])
    # the plan search (item 2) is ported: plan mode predicts the plan the
    # tuning cache commits, greedy on a miss, and raises no more
    monkeypatch.delenv("MXNET_TPU_TUNE_CACHE", raising=False)
    from mxnet_tpu_torch.autotune import CostModel
    model = CostModel()
    assert tanalysis.perf.check_predicted_plan([], [], {}, model).ok
    path = str(tmp_path / "m.json")
    model.save(path)
    assert main(["--model", "mlp", "--cost-model", path, "--plan"]) == 0
    assert tanalysis.verify_symbol(net, {"data": (2, 8)}, cost_model=model,
                                   plan=True).ok


def test_cli_json_equals_jax():
    from mxnet_tpu.analysis.__main__ import main as jmain
    from mxnet_tpu_torch.analysis.__main__ import main as tmain
    docs = []
    for main in (jmain, tmain):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--model", "mlp", "--model", "lenet", "--memory",
                       "--registry", "--json"])
        docs.append((rc, json.loads(buf.getvalue())))
    (jrc, jdoc), (trc, tdoc) = docs
    assert trc == jrc == 0

    def strip(doc):
        """Messages dropped; the digits of auto-generated node names
        blanked (each package counts its own names)."""
        if isinstance(doc, dict):
            return {k: strip(v) for k, v in doc.items() if k != "message"}
        if isinstance(doc, list):
            return [strip(v) for v in doc]
        if isinstance(doc, str):
            return re.sub(r"\d+", "#", doc)
        return doc
    assert strip(tdoc) == strip(jdoc)
    assert tdoc["targets"][0]["memory"]["peak_bytes"] == \
        jdoc["targets"][0]["memory"]["peak_bytes"] > 0


def test_module_bind_strict():
    for mx, sym in ((jmx, jsym), (tmx, tsym)):
        net = sym.SoftmaxOutput(_broken_fc(sym), name="softmax")
        mod = mx.mod.Module(symbol=net, label_names=("softmax_label",),
                            context=mx.cpu())
        with pytest.raises(mx.MXNetError, match="fcx"):
            mod.bind(data_shapes=[("data", (4, 10))],
                     label_shapes=[("softmax_label", (4,))], strict=True)
        ok = sym.SoftmaxOutput(sym.FullyConnected(
            sym.var("data"), num_hidden=4, name="fc1"), name="softmax")
        mod = mx.mod.Module(symbol=ok, label_names=("softmax_label",),
                            context=mx.cpu())
        mod.bind(data_shapes=[("data", (2, 8))],
                 label_shapes=[("softmax_label", (2,))], strict=True)
        assert mod.binded
