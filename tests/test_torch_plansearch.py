"""The port's plan search (``mxnet_tpu_torch.analysis.plansearch`` and the
decision hooks of ``analysis.fusion``) against the JAX package's: graph
digests of the zoo ResNet and the GPT, plans under every single decision,
the objective with one cost model, the beam's ranking, committed plans
read across the packages, and a graph's values and gradients under a
searched plan; and the port's own bind-time pickup (Executor and
ShardedTrainer), search-and-commit on the CPU, the CLI, MXG010's plan
mode."""
import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autotune as jautotune
from mxnet_tpu import models as jmodels
from mxnet_tpu.analysis import fusion as jfusion
from mxnet_tpu.analysis import infer_node_shapes as jinfer
from mxnet_tpu.analysis import plansearch as jplan
from mxnet_tpu.ops.fused import block_fusion as jblock_fusion
from mxnet_tpu_torch import autotune as tautotune
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import telemetry as ttelemetry
from mxnet_tpu_torch.analysis import fusion as tfusion
from mxnet_tpu_torch.analysis import infer_node_shapes as tinfer
from mxnet_tpu_torch.analysis import plansearch as tplan
from mxnet_tpu_torch.models.gpt import gpt_symbol
from mxnet_tpu_torch.ops.fused import block_fusion as tblock_fusion
from mxnet_tpu_torch.tools import plan_search as tplan_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"data": (4, 3, 8, 8), "softmax_label": (4,)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("MXNET_TPU_TUNE_CACHE", "MXNET_TPU_PLAN_SEARCH",
                 "MXNET_TPU_PLAN_BUDGET", "MXNET_TPU_PLAN_BEAM"):
        # set first, so that teardown restores it even where a tool under
        # test sets it in os.environ itself
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    for pkg in (jautotune, tautotune):
        pkg.CACHE.clear()
    for mod in (jplan, tplan):
        mod.reset_stats()
    # auto-named nodes count per package and process: build every graph in
    # scoped name managers, so that no later test's names move
    with jmx.name.NameManager(), tmx.name.NameManager():
        yield
    for pkg in (jautotune, tautotune):
        pkg.CACHE.clear()


def _conv_net(mx, num_classes=10):
    """conv3x3+BN+relu -> a K5-eligible conv1x1+BN+relu -> conv1x1+BN ->
    BN+relu -> FC+relu -> FC head: every chain kind."""
    d = mx.sym.Variable("data")
    n = mx.sym.Convolution(d, kernel=(3, 3), pad=(1, 1), num_filter=8,
                           no_bias=True, name="c0")
    n = mx.sym.BatchNorm(n, name="b0", fix_gamma=False)
    n = mx.sym.Activation(n, act_type="relu", name="r0")
    n = mx.sym.Convolution(n, kernel=(1, 1), num_filter=8, no_bias=True,
                           name="c1")
    n = mx.sym.BatchNorm(n, name="b1", fix_gamma=False)
    n = mx.sym.Activation(n, act_type="relu", name="r1")
    n = mx.sym.Convolution(n, kernel=(1, 1), num_filter=8, no_bias=True,
                           name="c2")
    n = mx.sym.BatchNorm(n, name="b2", fix_gamma=False)
    n = n + mx.sym.Pooling(n, kernel=(1, 1), pool_type="max", name="p2")
    n = mx.sym.BatchNorm(n, name="b3", fix_gamma=False)
    n = mx.sym.Activation(n, act_type="relu", name="r3")
    n = mx.sym.FullyConnected(mx.sym.Flatten(n), num_hidden=16, name="fc0")
    n = mx.sym.Activation(n, act_type="relu", name="fa0")
    n = mx.sym.FullyConnected(n, num_hidden=num_classes, name="fc1")
    return mx.sym.SoftmaxOutput(n, name="softmax")


def _pair():
    jnet = _conv_net(jmx)
    return jnet, tmx.sym.load_json(jnet.tojson())


def _blocks(plan):
    return sorted((b.name, b.kind, b.layout, bool(b.pallas), b.chain,
                   b.conv.name if b.conv is not None else None,
                   b.bn.name if b.bn is not None else None)
                  for b in plan.blocks.values())


def _same_plan(tp, jp):
    assert _blocks(tp) == _blocks(jp)
    for attr in ("overrides", "relayout_edges_added", "adjacent_edges",
                 "interior_edges", "plan_id"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    assert len(tp.skip) == len(jp.skip)


# ---------------------------------------------------------- identity
@pytest.mark.parametrize("name,kwargs", [
    ("resnet50", {"num_classes": 1000}), ("mlp", {"num_classes": 10}),
    ("inception-bn", {"num_classes": 10})])
def test_graph_digest_of_the_zoo_equals_jax(name, kwargs):
    j = jmodels.get_model(name, **kwargs)
    t = tmodels.get_model(name, **kwargs)
    want = jfusion.graph_digest(j._topo(), j._entries)
    assert tfusion.graph_digest(t._topo(), t._entries) == want
    # names are left out: a rebuild keeps the digest, a width does not
    t2 = tmodels.get_model(name, **kwargs)
    assert tfusion.graph_digest(t2._topo(), t2._entries) == want
    t3 = tmodels.get_model(name, num_classes=kwargs["num_classes"] + 1)
    assert tfusion.graph_digest(t3._topo(), t3._entries) != want


def test_graph_digest_of_the_gpt_equals_jax():
    """The port's ``gpt_symbol`` and the JAX example's
    (``examples/transformer/train_lm.py``) at the same widths."""
    spec = importlib.util.spec_from_file_location(
        "train_lm_for_digest",
        os.path.join(ROOT, "examples", "transformer", "train_lm.py"))
    lm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lm)
    j = lm.gpt_symbol(512, 64, 64, 4, 2, dropout=0.0)
    t = gpt_symbol(512, 64, 64, 4, 2, dropout=0.0)
    assert tfusion.graph_digest(t._topo(), t._entries) == \
        jfusion.graph_digest(j._topo(), j._entries)


@pytest.mark.parametrize("decisions", [
    None, {}, {"chains": {"3": "off"}}, {"layouts": {"7": "NCHW"}},
    {"pallas": {"11": 0}, "chains": {"3": "conv_bn"}}])
def test_decisions_id_equals_jax(decisions):
    assert tfusion.decisions_id(decisions) == jfusion.decisions_id(decisions)


def test_plan_decisions_context():
    assert tfusion.active_decisions() is None
    with tfusion.plan_decisions({"chains": {"1": "off"}}):
        assert tfusion.active_decisions() == {"chains": {"1": "off"}}
        with tfusion.plan_decisions(None):
            assert tfusion.active_decisions() is None
    assert tfusion.active_decisions() is None
    assert tfusion.CHAIN_CHOICES == jfusion.CHAIN_CHOICES


# ------------------------------------------------------------- plans
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("category", ["chains", "layouts", "pallas"])
def test_plans_under_every_move_equal_jax(layout, category):
    """Every single move of the search space (and the greedy plan): the
    same blocks, kinds, layouts, K5 flags, chains and accounting."""
    jnet, tnet = _pair()
    _g, jmoves = jplan.chain_moves(jnet._topo(), jnet._entries, layout)
    _g2, tmoves = tplan.chain_moves(tnet._topo(), tnet._entries, layout)
    assert tmoves == jmoves
    moves = [m for m in tmoves if m[0] == category]
    assert moves or (category == "pallas" and layout == "NCHW")
    for cat, cid, val in [(None, None, None)] + moves:
        dec = {} if cat is None else {cat: {cid: val}}
        jp = jfusion.plan_block_fusion(jnet._topo(), jnet._entries,
                                       layout=layout, record=False,
                                       decisions=dec)
        tp = tfusion.plan_block_fusion(tnet._topo(), tnet._entries,
                                       layout=layout, record=False,
                                       decisions=dec)
        _same_plan(tp, jp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resnet_plans_under_random_vectors_equal_jax(seed):
    """Random vectors of several decisions (stale chain ids among them) on
    the zoo ResNet-50 in NHWC."""
    jnet = jmodels.get_model("resnet50", num_classes=10)
    tnet = tmx.sym.load_json(jnet.tojson())
    _g, moves = tplan.chain_moves(tnet._topo(), tnet._entries, "NHWC")
    rng = np.random.RandomState(seed)
    dec = {}
    for i in rng.choice(len(moves), 12, replace=False):
        cat, cid, val = moves[i]
        dec.setdefault(cat, {})[cid] = val
    dec.setdefault("chains", {})["99999"] = "off"
    jp = jfusion.plan_block_fusion(jnet._topo(), jnet._entries,
                                   layout="NHWC", record=False,
                                   decisions=dec)
    tp = tfusion.plan_block_fusion(tnet._topo(), tnet._entries,
                                   layout="NHWC", record=False,
                                   decisions=dec)
    _same_plan(tp, jp)
    assert tp.overrides > 0
    ts, js = tp.summary(), jp.summary()
    for key in ("blocks", "kinds", "pallas_blocks", "relayouts_eliminated",
                "relayout_edges_added", "plan_id", "searched", "overrides"):
        assert ts[key] == js[key], key


def test_stale_decisions_degrade_to_fuse():
    _jnet, tnet = _pair()
    g = tfusion.plan_block_fusion(tnet._topo(), tnet._entries, record=False,
                                  decisions={})
    fc = next(b.chain for b in g.blocks.values() if b.kind == "fc_act")
    p = tfusion.plan_block_fusion(
        tnet._topo(), tnet._entries, record=False,
        decisions={"chains": {"9999": "off", fc: "conv_bn"}})
    assert _blocks(p) == _blocks(g)


# ---------------------------------------------------------- objective
def _cost_models():
    """One CostModel fitted on the same seeded records in both packages."""
    rng = np.random.RandomState(3)
    recs = [{"kind": "block", "wall_s": float(10.0 ** rng.uniform(-6, -3)),
             "flops": float(10.0 ** rng.uniform(5, 9)),
             "bytes_accessed": float(10.0 ** rng.uniform(4, 8)),
             "backend": "cpu", "block_config": {"bm": int(2 ** (3 + i % 4))}}
            for i in range(24)]
    return (tautotune.CostModel().fit(recs), jautotune.CostModel().fit(recs))


@pytest.mark.parametrize("fitted", [False, True])
@pytest.mark.parametrize("move", [None, ("layouts", "NHWC"),
                                  ("chains", "off"), ("chains", "conv_bn")])
def test_predict_plan_wall_equals_jax(fitted, move):
    jnet, tnet = _pair()
    tm, jm = _cost_models() if fitted else (None, None)
    jtopo, jshapes = jinfer(jnet, SHAPES)
    ttopo, tshapes = tinfer(tnet, SHAPES)
    dec = {}
    if move is not None:
        g = tfusion.plan_block_fusion(ttopo, tnet._entries, record=False,
                                      decisions={})
        cid = next(b.chain for b in g.blocks.values()
                   if b.kind == "conv_bn_act")
        dec = {move[0]: {cid: move[1]}}
    jp = jfusion.plan_block_fusion(jtopo, jnet._entries, record=False,
                                   decisions=dec)
    tp = tfusion.plan_block_fusion(ttopo, tnet._entries, record=False,
                                   decisions=dec)
    jt, ju = jplan.predict_plan_wall(jtopo, jnet._entries, jp, jshapes,
                                     model=jm, backend="cpu")
    tt, tu = tplan.predict_plan_wall(ttopo, tnet._entries, tp, tshapes,
                                     model=tm, backend="cpu")
    assert tt == pytest.approx(jt, rel=1e-6)
    assert [(u["unit"], u["name"], u["kind"]) for u in tu] == \
        [(u["unit"], u["name"], u["kind"]) for u in ju]
    for a, b in zip(tu, ju):
        assert a["predicted_s"] == pytest.approx(b["predicted_s"],
                                                 rel=1e-6)
        assert a["relayout_s"] == pytest.approx(b["relayout_s"], rel=1e-6)


@pytest.mark.parametrize("net,layout", [("conv", "NHWC"), ("conv", "NCHW"),
                                        ("resnet", "NHWC")])
def test_search_plan_ranking_equals_jax(net, layout):
    if net == "conv":
        jnet, tnet = _pair()
        shapes = SHAPES
    else:
        jnet = jmodels.get_model("resnet", num_layers=50, num_classes=10,
                                 image_shape="3,32,32")
        tnet = tmx.sym.load_json(jnet.tojson())
        shapes = {"data": (2, 3, 32, 32), "softmax_label": (2,)}
    tm, jm = _cost_models()
    jtopo, jshapes = jinfer(jnet, shapes)
    ttopo, tshapes = tinfer(tnet, shapes)
    jr = jplan.search_plan(jnet._topo(), jnet._entries, layout=layout,
                           node_shapes=jshapes, model=jm, budget=16, beam=4)
    tr = tplan.search_plan(tnet._topo(), tnet._entries, layout=layout,
                           node_shapes=tshapes, model=tm, budget=16, beam=4,
                           backend="cpu")
    assert [r["plan_id"] for r in tr] == [r["plan_id"] for r in jr]
    assert [r["predicted_s"] for r in tr] == pytest.approx(
        [r["predicted_s"] for r in jr], rel=1e-6)
    greedy = next(r for r in tr if not r["decisions"])
    assert tr[0]["predicted_s"] <= greedy["predicted_s"]


@pytest.mark.parametrize("value,budget,beam", [
    (None, 64, 8), ("12", 12, 12), ("0", 1, 1), ("x", 64, 8)])
def test_budget_and_beam_variables_equal_jax(monkeypatch, value, budget,
                                             beam):
    for name in ("MXNET_TPU_PLAN_BUDGET", "MXNET_TPU_PLAN_BEAM"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert tplan.plan_budget() == jplan.plan_budget() == budget
    assert tplan.plan_beam() == jplan.plan_beam() == beam
    assert tplan.plan_mode() == jplan.plan_mode() == "cache"


# ------------------------------------------------- commit and lookup
def _commit(pkg, topo, entries, decisions, layout="NCHW", mesh=None):
    graph = (jfusion if pkg is jautotune else tfusion).graph_digest(
        topo, entries)
    return pkg.put("graph_plan", [], [],
                   config={"decisions": decisions,
                           "plan_id": tfusion.decisions_id(decisions)},
                   wall_s=1e-3, mesh=mesh, backend="cpu",
                   extra={"graph": graph, "layout": layout},
                   source="plan-search")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_committed_decisions_round_trip(tmp_path, monkeypatch, writer):
    """A plan committed by either package's cache is read back at bind
    time by the port's, with the hit counted; another layout misses;
    ``MXNET_TPU_PLAN_SEARCH=off`` looks nothing up."""
    monkeypatch.setenv("MXNET_TPU_TUNE_CACHE", str(tmp_path))
    jnet, tnet = _pair()
    dec = {"chains": {"3": "off"}, "pallas": {"11": 0}}
    pkg = jautotune if writer == "jax" else tautotune
    pkg.reload_cache()
    src = jnet if writer == "jax" else tnet
    _commit(pkg, src._topo(), src._entries, dec)
    tautotune.reload_cache()
    h0 = ttelemetry.counter("mxtpu_plan_cache_hit_total").get()
    assert tplan.committed_decisions(tnet._topo(), tnet._entries,
                                     "NCHW") == dec
    assert tplan.stats() == {"hits": 1, "misses": 0}
    assert ttelemetry.counter("mxtpu_plan_cache_hit_total").get() == h0 + 1
    assert tplan.committed_decisions(tnet._topo(), tnet._entries,
                                     "NHWC") is None
    assert tplan.stats() == {"hits": 1, "misses": 1}
    # and the JAX package reads the same entry
    jautotune.reload_cache()
    assert jplan.committed_decisions(jnet._topo(), jnet._entries,
                                     "NCHW") == dec
    monkeypatch.setenv("MXNET_TPU_PLAN_SEARCH", "off")
    tplan.reset_stats()
    assert tplan.committed_decisions(tnet._topo(), tnet._entries,
                                     "NCHW") is None
    assert tplan.stats() == {"hits": 0, "misses": 0}


def _bind(mx, sym, ctx):
    ex = sym.simple_bind(ctx, **SHAPES)
    rng = np.random.RandomState(0)
    for name in sorted(ex.arg_dict):
        arr = ex.arg_dict[name]
        arr[:] = (rng.randint(0, 10, arr.shape) if name == "softmax_label"
                  else rng.uniform(-0.5, 0.5, arr.shape)).astype(np.float32)
    return ex


def _jax_test_net(mx):
    """``tests/test_plansearch.py``'s net: conv3x3+BN+relu, a K5-eligible
    conv1x1+BN+relu, FC+relu, the FC head."""
    d = mx.sym.Variable("data")
    n = mx.sym.Convolution(d, kernel=(3, 3), pad=(1, 1), num_filter=8,
                           no_bias=True, name="c0")
    n = mx.sym.BatchNorm(n, name="b0", fix_gamma=False)
    n = mx.sym.Activation(n, act_type="relu", name="r0")
    n = mx.sym.Convolution(n, kernel=(1, 1), num_filter=8, no_bias=True,
                           name="c1")
    n = mx.sym.BatchNorm(n, name="b1", fix_gamma=False)
    n = mx.sym.Activation(n, act_type="relu", name="r1")
    n = mx.sym.FullyConnected(mx.sym.Flatten(n), num_hidden=16, name="fc0")
    n = mx.sym.Activation(n, act_type="relu", name="fa0")
    n = mx.sym.FullyConnected(n, num_hidden=10, name="fc1")
    return mx.sym.SoftmaxOutput(n, name="softmax")


def _close(got, want, rtol, atol):
    """Within ``rtol``, and ``atol`` of the array's largest entry where
    that exceeds 1 (the repo's convention: a gradient sums many terms with
    cancellation, so its rounding follows the terms' size)."""
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("which", ["split_layout_veto_off",
                                   "conv_bn_nhwc"])
def test_eval_graph_under_decisions_equals_jax(which):
    """A forward and backward under a non-greedy vector, f32, the port's
    Executor against the JAX one: the outputs to rtol 1e-5, atol 1e-6; the
    gradients to the fused regions' rtol 1e-4, atol 1e-5
    (``test_torch_resnet_ops``: a region's backward chains a conv's
    gradient behind the BN gradient's reductions; under the greedy plan
    the BN scales' gradients already differ by 1.2e-6 of their largest
    entry)."""
    jnet = _jax_test_net(jmx)
    tnet = tmx.sym.load_json(jnet.tojson())
    g = tfusion.plan_block_fusion(tnet._topo(), tnet._entries, record=False,
                                  decisions={})
    chains = {b.name: b.chain for b in g.blocks.values()}
    dec = {"split_layout_veto_off": {
        "chains": {chains["r0"]: "bn_act", chains["fa0"]: "off"},
        "layouts": {chains["r1"]: "NHWC"}, "pallas": {chains["r1"]: 0}},
        "conv_bn_nhwc": {"chains": {chains["r0"]: "conv_bn"},
                         "layouts": {chains["r0"]: "NHWC",
                                     chains["r1"]: "NHWC"}}}[which]
    outs = []
    for mx, bf, fusion, net in ((jmx, jblock_fusion, jfusion, jnet),
                                (tmx, tblock_fusion, tfusion, tnet)):
        with bf(True), fusion.plan_decisions(dec):
            ex = _bind(mx, net, mx.cpu())
        assert ex._plan_decisions == dec
        ex.forward(is_train=True)
        out = ex.outputs[0].asnumpy()
        ex.backward()
        grads = {k: v.asnumpy() for k, v in ex.grad_dict.items()
                 if v is not None}
        outs.append((out, grads, fusion.last_plan_summary()))
    (jo, jg, js), (to, tg, ts) = outs
    _close(to, jo, 1e-5, 1e-6)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        _close(tg[k], jg[k], 1e-4, 1e-5)
    assert ts["plan_id"] == js["plan_id"] == tfusion.decisions_id(dec)
    assert ts["kinds"] == js["kinds"] and ts["overrides"] > 0


def test_executor_bind_picks_up_a_jax_committed_plan(tmp_path, monkeypatch):
    """A plan the JAX package committed, read by a port Executor bound on a
    rebuilt graph (other auto names): it dispatches that plan."""
    monkeypatch.setenv("MXNET_TPU_TUNE_CACHE", str(tmp_path))
    jautotune.reload_cache()
    jnet = _conv_net(jmx)
    g = jfusion.plan_block_fusion(jnet._topo(), jnet._entries, record=False,
                                  decisions={})
    cid = next(b.chain for b in g.blocks.values() if b.name == "r0")
    dec = {"chains": {cid: "conv_bn"}}
    _commit(jautotune, jnet._topo(), jnet._entries, dec)
    tautotune.reload_cache()
    with tblock_fusion(True):
        ex = _bind(tmx, _conv_net(tmx), tmx.cpu())
    assert ex._plan_decisions == dec
    ex.forward(is_train=True)
    s = tfusion.last_plan_summary()
    assert s["plan_id"] == tfusion.decisions_id(dec) and s["searched"]
    assert "conv_bn" in s["kinds"]
    # without fusion no lookup is made
    tplan.reset_stats()
    _bind(tmx, _conv_net(tmx), tmx.cpu())
    assert tplan.stats() == {"hits": 0, "misses": 0}


def test_trainer_picks_up_the_mesh_keyed_plan(tmp_path, monkeypatch):
    """ShardedTrainer keys its lookup by its mesh's axis sizes (a
    one-device mesh's, as JAX keys it); an Executor-keyed entry (no mesh)
    is not the trainer's."""
    from mxnet_tpu_torch.parallel import ShardedTrainer, build_mesh
    monkeypatch.setenv("MXNET_TPU_TUNE_CACHE", str(tmp_path))
    tautotune.reload_cache()
    tnet = _conv_net(tmx)
    dec = {"pallas": {"11": 0}}
    _commit(tautotune, tnet._topo(), tnet._entries, dec, layout="NHWC",
            mesh={"data": 1, "model": 1})

    def trainer():
        return ShardedTrainer(
            tnet, build_mesh(devices=[tmx.cpu()]),
            data_shapes={"data": SHAPES["data"]},
            label_shapes={"softmax_label": SHAPES["softmax_label"]},
            layout="NHWC", fuse_blocks=True)

    tr = trainer()
    assert tr._plan_decisions == dec
    batch = tr.put_batch({"data": np.zeros(SHAPES["data"], np.float32),
                          "softmax_label": np.zeros(4, np.float32)})
    assert np.isfinite(float(tr.step(batch)))
    assert tr.fusion_summary()["plan_id"] == tfusion.decisions_id(dec)
    monkeypatch.setenv("MXNET_TPU_TUNE_CACHE", str(tmp_path / "executor"))
    tautotune.reload_cache()
    _commit(tautotune, tnet._topo(), tnet._entries, dec, layout="NHWC")
    assert trainer()._plan_decisions is None


def test_search_and_commit_contract():
    """Greedy is always measured; the winner is no worse than greedy
    predicted and measured; a second search is a hit with no search."""
    net = tmodels.get_model("mlp", num_classes=10)
    shapes = {"data": (4, 784), "softmax_label": (4,)}
    cache = tautotune.TuneCache()
    doc = tplan.search_and_commit(net, shapes, layout="NCHW", budget=8,
                                  beam=4, topk=2, repeats=1, cache=cache,
                                  device="cpu")
    assert doc["predicted_s"] <= doc["greedy_predicted_s"] * (1 + 1e-9)
    assert doc["wall_s"] <= doc["greedy_wall_s"]
    assert doc["measured"] >= 1 and len(cache) == 1
    entry = cache.entries()[0]
    assert entry["op"] == "graph_plan" and entry["backend"] == "cpu"
    assert entry["extra"] == {"graph": doc["graph"], "layout": "NCHW"}
    doc2 = tplan.search_and_commit(net, shapes, layout="NCHW", cache=cache,
                                   device="cpu")
    assert doc2["cached"] and doc2["searched"] == 0
    assert doc2["plan_id"] == doc["plan_id"]


def test_measure_decisions_runs_a_training_step():
    _jnet, tnet = _pair()
    wall = tplan.measure_decisions(tnet, SHAPES, {"chains": {"3": "off"}},
                                   layout="NHWC", repeats=1, device="cpu")
    assert wall > 0
    args, aux, vals = tplan.build_step_values(tnet, SHAPES, layout="NHWC")
    jargs, jaux, jvals = jplan.build_step_values(_pair()[0], SHAPES,
                                                 layout="NHWC")
    assert [n.name for n in args] == [n.name for n in jargs]
    for a, b in zip(vals, jvals):
        np.testing.assert_array_equal(a, b)


def _plan_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tplan_tool.main(argv + ["--json"])
    return rc, json.loads(buf.getvalue())


def test_plan_search_cli_second_run_is_cached(tmp_path):
    argv = ["--model", "mlp", "--batch", "4", "--cpu", "--budget", "6",
            "--beam", "2", "--topk", "1", "--repeats", "1", "--mesh",
            "data=1,model=1", "--cache", str(tmp_path)]
    rc, doc = _plan_cli(argv)
    assert rc == 0 and not doc["cached"] and doc["measured"] >= 1
    assert doc["mesh"] == {"data": 1, "model": 1}
    rc, doc2 = _plan_cli(argv)
    assert rc == 0 and doc2["cached"] and doc2["plan_id"] == doc["plan_id"]
    # the JAX package reads the committed entry under the same key
    jentries, _s = jautotune.read_entries(str(tmp_path), strict=True)
    assert [e["op"] for e in jentries] == ["graph_plan"]
    with pytest.raises(SystemExit):
        tplan_tool.main(["--model", "mlp", "--mesh", "bad"])
    assert tplan_tool.main(["--model", "nonesuch", "--cpu"]) == 2


def test_mxg010_plan_mode_names_the_plan(tmp_path, monkeypatch):
    """MXG010 ``plan=True`` predicts the committed plan (greedy on a miss)
    and names it in each finding, in the JAX package's words."""
    from mxnet_tpu.analysis import verify_model as jverify
    from mxnet_tpu_torch.analysis import verify_model as tverify
    tm, jm = _cost_models()
    monkeypatch.setenv("MXNET_TPU_PLAN_SEARCH", "off")
    msgs = []
    for verify, model in ((jverify, jm), (tverify, tm)):
        _net, report = verify("lenet", cost_model=model, plan=True,
                              plan_layout="NCHW")
        msgs.append(sorted(d.message for d in report
                           if d.rule == "MXG010"))
    assert msgs[1] == msgs[0]
    assert all("committed plan greedy" in m for m in msgs[1])


def test_analysis_cli_plan_flag(tmp_path, capsys):
    from mxnet_tpu_torch.analysis.__main__ import main
    tm, _jm = _cost_models()
    path = str(tmp_path / "cm.json")
    tm.save(path)
    assert main(["--model", "mlp", "--cost-model", path, "--plan",
                 "--layout", "NCHW"]) == 0
    with pytest.raises(SystemExit) as e:
        main(["--model", "mlp", "--plan"])
    assert e.value.code == 2
    assert "cost-model" in capsys.readouterr().err
