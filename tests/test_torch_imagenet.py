"""``tools.train_imagenet`` on the CPU (``--cpu 1``) from a small JPEG
``.rec``, against the JAX package: the fused route with and without the
device queue, five steps of ResNet-18 at 3x32x32, batch 8, f32, in
lockstep with the JAX ``ShardedTrainer`` fed the same decoded batches (the
losses within relative 1e-4, each leaf's update within the bounds set from
sound and planted-fault readings); the fused route's NCHW fallback for a
graph refused NHWC, fed the same raw uint8 batches; the Module route under
``MXNET_FUSE_BLOCKS=1`` against the JAX Module route under the same
variable, the same fusion plan in both; the store's update on the
gradients' device; the ``config`` catalog and the block-fusion flag's
environment default; the tool's refusals; and chip_smoke's ImageNet phases
at a small size."""
import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import config as jconfig  # noqa: E402
from mxnet_tpu.analysis import fusion as jfusion  # noqa: E402
from mxnet_tpu.models import get_model as jget_model  # noqa: E402
from mxnet_tpu.ops import fused as jfused  # noqa: E402
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer  # noqa: E402
from mxnet_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch import config as pconfig  # noqa: E402
from mxnet_tpu_torch.analysis import fusion as pfusion  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.convert import from_jax_trainer_state  # noqa: E402
from mxnet_tpu_torch.models import get_model  # noqa: E402
from mxnet_tpu_torch.ops import fused as pfused  # noqa: E402
from mxnet_tpu_torch.parallel import ShardedTrainer  # noqa: E402
from mxnet_tpu_torch.parallel import build_mesh  # noqa: E402
from mxnet_tpu_torch.tools import fit as pfit  # noqa: E402
from mxnet_tpu_torch.tools import train_imagenet  # noqa: E402
from mxnet_tpu_torch.tools.io_train_bench import make_class_rec  # noqa: E402

BATCH = 8
STEPS = 5
LR = 0.05


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    d = tmp_path_factory.mktemp("imagenet")
    out = {}
    for name, n, seed in (("train", BATCH * STEPS, 0), ("val", 16, 1),
                          ("module", BATCH, 2)):
        out[name] = str(d / (name + ".rec"))
        make_class_rec(out[name], n, size=40, classes=4, seed=seed)
    return out


def _argv(recs, *extra):
    return ["--cpu", "1", "--network", "resnet", "--num-layers", "18",
            "--image-shape", "3,32,32", "--batch-size", str(BATCH),
            "--num-epochs", "1", "--data-train", recs["train"],
            "--data-nthreads", "1", "--dtype", "float32", "--lr", str(LR),
            "--disp-batches", "2"] + list(extra)


def _net(mod_get_model):
    return mod_get_model("resnet", num_classes=1000, num_layers=18,
                         image_shape="3,32,32")


def _jax_batches(rec):
    """The JAX native iterator's batches of ``rec`` as the fit's first
    epoch reads them (one decode thread, reset once): f32 NCHW."""
    it = jmx.io.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, 32, 32), batch_size=BATCH,
        shuffle=True, rand_crop=True, rand_mirror=True,
        preprocess_threads=1)
    it.reset()
    return [{"data": b.data[0].asnumpy(),
             "softmax_label": b.label[0].asnumpy()} for b in it]


def _jax_trainer():
    """The JAX trainer as the fit builds it (auto_layouts aside)."""
    np.random.seed(0)
    return JaxTrainer(
        _net(jget_model), jax_build_mesh(n_devices=1),
        data_shapes={"data": (BATCH, 3, 32, 32)},
        label_shapes={"softmax_label": (BATCH,)}, optimizer="sgd",
        learning_rate=LR, momentum=0.9, weight_decay=1e-4,
        dtype="float32", layout="NHWC", fuse_blocks=True,
        initializer=jmx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))


def _jax_state(jt):
    return ({k: np.asarray(v) for k, v in jt.params.items()},
            {k: [np.asarray(s) for s in v] for k, v in jt.opt_state.items()},
            {k: np.asarray(v) for k, v in jt.aux.items()})


def _rel(got, want):
    a = np.concatenate([np.asarray(got[k]).ravel() for k in sorted(want)])
    b = np.concatenate([np.asarray(want[k]).ravel() for k in sorted(want)])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _update_readings(after, before, want):
    """The port's update, ``after - before``, against the reference's,
    ``want - before``, both from the state ``before`` (in f64): the worst
    leaf's ``(name, || port - reference || / || reference ||)``, and
    ``<port, reference> / <reference, reference> - 1`` over all the leaves
    together, which reads a scaled update (a wrong lr or momentum) apart
    from the leaves' rounding noise."""
    worst = ("", 0.0)
    got_all, ref_all = [], []
    for k in sorted(want):
        b = np.asarray(before[k], np.float64)
        ref = (np.asarray(want[k], np.float64) - b).ravel()
        got = (np.asarray(after[k], np.float64) - b).ravel()
        err = np.linalg.norm(got - ref)
        rel = err / np.linalg.norm(ref) if err else 0.0
        if rel > worst[1]:
            worst = (k, rel)
        got_all.append(got)
        ref_all.append(ref)
    got_all, ref_all = np.concatenate(got_all), np.concatenate(ref_all)
    return worst, float(got_all @ ref_all / (ref_all @ ref_all) - 1)


# bounds of the update readings (:func:`_update_readings`) for ResNet-18
# at this size, whose updates carry the rounding noise that the docstring
# of test_fused_route_matches_jax measures; the readings each bound sits
# between are in each test's docstring
TOL_LEAF_UPDATE = 0.1
TOL_UPDATE_SCALE = 3e-3


def _assert_updates(readings, tol_leaf=TOL_LEAF_UPDATE,
                    tol_scale=TOL_UPDATE_SCALE):
    (leaf, rel), scale = readings
    assert rel <= tol_leaf, (leaf, rel)
    assert abs(scale) <= tol_scale, scale


def _fused_lockstep(recs, monkeypatch, net, jt, *extra):
    """Run the tool's fused route over ``recs["train"]`` with each port
    step in lockstep with the JAX trainer ``jt``: the JAX state carried
    into the port's before the step, both step on their own decoded batch
    (the port's staged values equal to the JAX batch's), the states after
    the step within relative 1e-3 by their norms, and each step's ``(port
    loss, JAX loss, parameter updates, moving-statistic updates)``
    recorded, the updates read by :func:`_update_readings`.  Returns the
    records, the fit's history and the port's trainer."""
    batches = _jax_batches(recs["train"])
    seen = []
    port_step = ShardedTrainer.step

    def lockstep(self, batch):
        jb = batches[len(seen)]
        want = jb["data"] if self._layout == "NCHW" \
            else jb["data"].transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(batch["data"].numpy(), want)
        params, slots, aux = _jax_state(jt)
        from_jax_trainer_state(self, params, slots, aux=aux)
        jl = float(jt.step(jb))
        loss = port_step(self, batch)
        jparams, _slots, jaux = _jax_state(jt)
        mine = {k: v.numpy() for k, v in self.params.items()}
        mine_aux = {k: v.numpy() for k, v in self.aux.items()}
        assert _rel(mine, jparams) <= 1e-3
        assert _rel(mine_aux, jaux) <= 1e-3
        seen.append((float(loss), jl,
                     _update_readings(mine, params, jparams),
                     _update_readings(mine_aux, aux, jaux)))
        return loss

    monkeypatch.setattr(ShardedTrainer, "step", lockstep)
    args = train_imagenet.parser().parse_args(_argv(recs, *extra))
    history = {}
    trainer = pfit.fit(args, net, train_imagenet.get_rec_iter,
                       history=history)
    return seen, history, trainer


@pytest.mark.parametrize("queue", [0, 1])
def test_fused_route_matches_jax(recs, queue, monkeypatch):
    """Five steps of the tool's fused route in lockstep with the JAX
    trainer (:func:`_fused_lockstep`): the losses agree within relative
    1e-4, and each step's update of every parameter and every moving
    statistic (the state after the step less the state carried in) agrees
    with the JAX trainer's update of that leaf within relative
    ``TOL_LEAF_UPDATE``, and over all leaves in scale within
    ``TOL_UPDATE_SCALE``.

    Lockstep, because at this size a trajectory is chaotic: the JAX
    trainer's own fifth loss moves 7% when its input is scaled by
    1 + 2^-22.  Its updates carry that noise too: from the same state, the
    JAX trainer's own worst leaf moves 2.4e-2 when its input is scaled by
    1 + 2^-22 (which ``bn_data`` normalizes away but for rounding) and
    3.7e-2 when 2^-10 is added to it.  Readings of the port against JAX,
    over the five steps: sound, the worst parameter 4.7e-2 (bn_data_beta),
    the worst moving statistic 2.3e-2, the scale 9.6e-4 (parameters) and
    1.6e-4 (statistics).  Planted faults: weight decay dropped, 1.0
    (bn_data_gamma, whose update is weight decay's alone); one leaf's
    update left out, 1.0; the lr 1% high, scale 1.0e-2; momentum 0.95 for
    0.9, scale 5.1e-2."""
    jt = _jax_trainer()
    seen, history, trainer = _fused_lockstep(
        recs, monkeypatch, _net(get_model), jt,
        "--fused", "1", "--device-queue", str(queue))
    assert len(seen) == STEPS == len(history["losses"])
    for pl, jl, params, aux in seen:
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
        _assert_updates(params)
        _assert_updates(aux)
    assert history["queue"] == bool(queue)
    assert trainer._input_mean == (0.0, 0.0, 0.0)   # raw uint8 batches
    assert history["fusion"]["blocks"] == jt.fusion_summary()["blocks"]


def _concat_net(m):
    """A small net with ``Concat(dim=1)``, which both trainers refuse to
    run NHWC."""
    data = m.sym.Variable("data")
    a = m.sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                          no_bias=True, name="a")
    b = m.sym.Convolution(data, kernel=(1, 1), num_filter=4, no_bias=True,
                          name="b")
    x = m.sym.Concat(a, b, dim=1, name="cat")
    x = m.sym.BatchNorm(x, fix_gamma=False, name="bn")
    x = m.sym.Activation(x, act_type="relu", name="relu")
    x = m.sym.Pooling(x, kernel=(1, 1), global_pool=True, pool_type="avg",
                      name="pool")
    x = m.sym.FullyConnected(m.sym.Flatten(x), num_hidden=4, name="fc")
    return m.sym.SoftmaxOutput(x, name="softmax")


def test_fused_route_falls_back_to_nchw_with_raw_batches(recs, monkeypatch):
    """A graph refused NHWC trains NCHW on the fused route from the same
    raw uint8 NHWC batches, which ``put_batch`` permutes and normalizes on
    the device: lockstep with the JAX trainer in NCHW fed its f32 NCHW
    batches.  This net is well conditioned, so its leaves are held tighter:
    sound, the worst leaf 2.3e-5, the scale 1.2e-5; planted, weight decay
    dropped 2.2e-3 (a leaf) and the lr 1% high 1.0e-2 (the scale)."""
    with pytest.raises(MXNetError, match="Concat"):
        ShardedTrainer(_concat_net(tmx), build_mesh(devices=[tmx.cpu()]),
                       data_shapes={"data": (BATCH, 3, 32, 32)},
                       label_shapes={"softmax_label": (BATCH,)},
                       layout="NHWC")
    np.random.seed(0)
    jt = JaxTrainer(
        _concat_net(jmx), jax_build_mesh(n_devices=1),
        data_shapes={"data": (BATCH, 3, 32, 32)},
        label_shapes={"softmax_label": (BATCH,)}, optimizer="sgd",
        learning_rate=LR, momentum=0.9, weight_decay=1e-4,
        dtype="float32", fuse_blocks=True,
        initializer=jmx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    seen, history, trainer = _fused_lockstep(
        recs, monkeypatch, _concat_net(tmx), jt, "--fused", "1")
    assert trainer._layout == "NCHW" and history["queue"]
    assert trainer._input_mean == (0.0, 0.0, 0.0)   # raw uint8 batches
    assert len(seen) == STEPS
    for pl, jl, params, aux in seen:
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
        _assert_updates(params, tol_leaf=1e-3)
        _assert_updates(aux, tol_leaf=1e-3)


def test_fused_route_queue_is_bit_identical(recs):
    losses = []
    for queue in (0, 1):
        args = train_imagenet.parser().parse_args(
            _argv(recs, "--fused", "1", "--device-queue", str(queue)))
        history = {}
        pfit.fit(args, _net(get_model), train_imagenet.get_rec_iter,
                 history=history)
        losses.append(history["losses"])
    assert len(losses[0]) == STEPS and losses[0] == losses[1]


def _load_jax_example():
    path = os.path.join(ROOT, "examples", "image_classification",
                        "train_imagenet.py")
    spec = importlib.util.spec_from_file_location("jax_train_imagenet",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _snapshot_at_init_optimizer(monkeypatch, module_cls, into):
    """Record a Module's parameters as ``fit`` hands them to the optimizer
    (the state its first update starts from) in ``into``."""
    orig = module_cls.init_optimizer

    def init_optimizer(self, *args, **kwargs):
        arg, aux = self.get_params()
        into.append(({k: np.array(v.asnumpy()) for k, v in arg.items()},
                     {k: np.array(v.asnumpy()) for k, v in aux.items()}))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(module_cls, "init_optimizer", init_optimizer)


def test_module_route_under_fuse_blocks_matches_jax(recs, monkeypatch):
    """One batch of the Module route (one update from the same weights:
    past the first, the trajectories part as the fused route's do): the
    same fusion plan, the same initial state, and each parameter's and
    moving statistic's update within the bounds of the fused route's
    test (the states themselves within relative 1e-4).  Sound readings: the worst leaf 1.3e-2 (parameters) and 2.1e-4
    (moving statistics), the scale 1.7e-4 and 1.0e-5; weight decay
    dropped reads 1.0 (bn_data_gamma), the lr 1% high 9.8e-3 (the
    scale)."""
    monkeypatch.setenv("MXNET_FUSE_BLOCKS", "1")
    argv = _argv(dict(recs, train=recs["module"]), "--fused", "0")
    args = train_imagenet.parser().parse_args(argv)
    starts = []
    _snapshot_at_init_optimizer(monkeypatch, tmx.mod.Module, starts)
    _snapshot_at_init_optimizer(monkeypatch, jmx.mod.Module, starts)
    model = pfit.fit(args, _net(get_model), train_imagenet.get_rec_iter)
    port_plan = pfusion.last_plan_summary()
    jexample = _load_jax_example()
    from common import fit as jfit      # the example's own harness
    np.random.seed(0)
    jargs = argparse.Namespace(**vars(args))
    jmodel = jfit.fit(jargs, _net(jget_model), jexample.get_rec_iter)
    jax_plan = jfusion.last_plan_summary()
    for key in ("layout", "blocks", "kinds", "pallas_blocks"):
        assert port_plan[key] == jax_plan[key], key
    assert port_plan["layout"] == "NCHW" and port_plan["blocks"] > 0
    assert port_plan["pallas_blocks"] == 0
    (parg0, paux0), (jarg0, jaux0) = starts
    assert sorted(parg0) == sorted(jarg0)
    for k in jarg0:
        np.testing.assert_array_equal(parg0[k], jarg0[k], err_msg=k)
    for k in jaux0:
        np.testing.assert_array_equal(paux0[k], jaux0[k], err_msg=k)
    parg, paux = model.get_params()
    jarg, jaux = jmodel.get_params()
    parg = {k: v.asnumpy() for k, v in parg.items()}
    jarg = {k: v.asnumpy() for k, v in jarg.items()}
    paux = {k: v.asnumpy() for k, v in paux.items()}
    jaux = {k: v.asnumpy() for k, v in jaux.items()}
    assert _rel(parg, jarg) <= 1e-4 and _rel(paux, jaux) <= 1e-4
    _assert_updates(_update_readings(parg, jarg0, jarg))
    _assert_updates(_update_readings(paux, jaux0, jaux))


@pytest.mark.parametrize("kv_type", ["local", "device"])
def test_kvstore_updates_where_the_gradients_are(kv_type):
    """The Module route on the card hands the store CPU weights and card
    gradients.  Either store type moves the weight to the gradients'
    device once and updates it there, as the JAX store, whose ``local``
    and ``device`` coincide.  ``meta`` stands in for the card here."""
    import torch
    from mxnet_tpu_torch import kvstore
    from mxnet_tpu_torch.ndarray import NDArray
    kv = kvstore.create(kv_type)
    kv.init(3, NDArray(torch.ones(4)))
    seen = []
    kv.set_updater(lambda k, grad, weight: seen.append(
        (k, grad.data.device.type, weight.data.device.type, id(weight))))
    kv.push(3, [NDArray(torch.ones(4, device="meta")),
                NDArray(torch.ones(4, device="meta"))])
    kv.push(3, NDArray(torch.ones(4, device="meta")))
    assert [s[:3] for s in seen] == [(3, "meta", "meta")] * 2
    assert seen[0][3] == seen[1][3] == id(kv._store[3])


def test_config_catalog_matches_jax(monkeypatch):
    pcat, jcat = pconfig.describe(), jconfig.describe()
    assert sorted(pcat) == sorted(jcat)
    for name in jcat:
        assert pcat[name][0] == jcat[name][0], name
        assert pcat[name][1] in ("honored", "inert")
        assert "XLA" not in pcat[name][2] and "jax" not in pcat[name][2]
    for name in ("MXNET_FUSE_BLOCKS", "MXNET_USE_NATIVE_REC",
                 "MXNET_TPU_BAD_RECORD_QUOTA"):
        assert pcat[name][1] == "honored"
    monkeypatch.setenv("MXNET_TPU_BAD_RECORD_QUOTA", "7")
    monkeypatch.setenv("MXNET_USE_NATIVE_REC", "true")
    for mod in (pconfig, jconfig):
        assert mod.get_int("MXNET_TPU_BAD_RECORD_QUOTA") == 7
        assert mod.get_bool("MXNET_USE_NATIVE_REC")
        assert mod.get("MXNET_FUSE_BLOCKS") == "0"
        assert mod.get("NOT_IN_THE_CATALOG", "x") == "x"
        assert mod.get_int("MXNET_TPU_COORDINATOR") == 0


@pytest.mark.parametrize("env", [None, "0", "1", "true"])
def test_block_fusion_flag_reads_the_environment_as_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("MXNET_FUSE_BLOCKS", raising=False)
    else:
        monkeypatch.setenv("MXNET_FUSE_BLOCKS", env)
    assert pfused.block_fusion_enabled() == jfused.block_fusion_enabled()
    for force in (True, False):
        with pfused.block_fusion(force), jfused.block_fusion(force):
            assert pfused.block_fusion_enabled() is force
            assert jfused.block_fusion_enabled() is force
    with pfused.block_fusion(None):
        assert pfused.block_fusion_enabled() == (env == "1")
    trainer = ShardedTrainer(
        _net(get_model), build_mesh(devices=[tmx.cpu()]),
        data_shapes={"data": (2, 3, 32, 32)},
        label_shapes={"softmax_label": (2,)}, layout="NHWC")
    assert trainer._fuse_blocks == (env == "1")
    forced = ShardedTrainer(
        _net(get_model), build_mesh(devices=[tmx.cpu()]),
        data_shapes={"data": (2, 3, 32, 32)},
        label_shapes={"softmax_label": (2,)}, layout="NHWC",
        fuse_blocks=False)
    assert not forced._fuse_blocks


def _bind_and_forward(mod, getm):
    """A Module of the small ResNet bound on the CPU and run forward once
    in training mode."""
    data = np.random.RandomState(0).rand(4, 3, 32, 32).astype("f")
    m = mod.mod.Module(_net(getm), context=mod.cpu())
    m.bind(data_shapes=[("data", (4, 3, 32, 32))],
           label_shapes=[("softmax_label", (4,))])
    m.init_params(mod.initializer.Xavier(magnitude=2))
    m.forward(mod.io.DataBatch([mod.nd.array(data, ctx=mod.cpu())],
                               [mod.nd.array(np.zeros(4, "f"),
                                             ctx=mod.cpu())]),
              is_train=True)
    return m


def test_executor_binds_under_the_variable(monkeypatch):
    """A Module bound under MXNET_FUSE_BLOCKS=1 plans the JAX Module's
    blocks; bound without it, it runs unfused, as the JAX Module does."""
    monkeypatch.setenv("MXNET_FUSE_BLOCKS", "1")
    m = _bind_and_forward(tmx, get_model)
    port_plan = pfusion.last_plan_summary()
    _bind_and_forward(jmx, jget_model)
    jax_plan = jfusion.last_plan_summary()
    assert m._exec_group.execs[0]._block_fusion is True
    for key in ("layout", "blocks", "kinds", "pallas_blocks"):
        assert port_plan[key] == jax_plan[key], key
    assert port_plan["blocks"] > 0
    monkeypatch.setenv("MXNET_FUSE_BLOCKS", "0")
    m = _bind_and_forward(tmx, get_model)
    assert m._exec_group.execs[0]._block_fusion is False


def test_the_tool_refuses_the_cpu_unless_asked(recs):
    args = train_imagenet.parser().parse_args(
        _argv(recs, "--fused", "1")[2:])       # without --cpu 1
    assert args.cpu == 0
    with pytest.raises(MXNetError, match="--cpu 1"):
        pfit.fit(args, _net(get_model), train_imagenet.get_rec_iter)


def test_fused_checkpoint_arguments_raise_before_a_step(recs):
    args = train_imagenet.parser().parse_args(
        _argv(recs, "--fused", "1", "--model-prefix", "/nonexistent/m"))
    history = {}
    with pytest.raises(MXNetError, match="not yet ported"):
        pfit.fit(args, _net(get_model), train_imagenet.get_rec_iter,
                 history=history)
    assert "losses" not in history


def test_main_prints_one_json_line(recs, capsys):
    out = train_imagenet.main(_argv(recs, "--fused", "1", "--data-val",
                                    recs["val"], "--top-k", "2"))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["losses"] == out["losses"]
    assert out["decoder"] == "libjpeg" and out["route"] == "fused"
    assert len(out["losses"]) == STEPS and np.isfinite(out["losses"]).all()
    val = out["epochs"][0]["val"]
    assert set(val) == {"accuracy", "top_k_accuracy_2"}
    assert set(out["timings"]) >= {"fetch_s", "stage_s", "step_dispatch_s",
                                   "queue_wait_s"}


def test_benchmark_data_is_staged_once(recs):
    args = train_imagenet.parser().parse_args(
        _argv(recs, "--fused", "1", "--benchmark", "1", "--batch-size", "2",
              "--num-epochs", "2", "--device-queue", "1"))
    history = {}
    pfit.fit(args, _net(get_model), train_imagenet.get_rec_iter,
             history=history)
    assert not history["queue"] and len(history["losses"]) == 2 * 32


def test_chip_smoke_imagenet_phases_at_a_small_size(tmp_path):
    recs, _s = chip_smoke.make_image_records(
        str(tmp_path), {"train": (32, 0), "val": (8, 1), "module": (8, 2)},
        size=40)
    io = chip_smoke.image_io_phase(recs, image=32, batch=4, size=40)
    assert io["decoder"] == "libjpeg" and io["multiset_equal"]
    assert io["vs_pil"]["4:2:0"]["max_abs"] == 0
    assert io["vs_pil"]["4:4:4"]["max_abs"] == 0
    assert set(io["decode_images_per_s"]) >= {1, 2, 4}
    assert io["image_iter_images_per_s"] > 0
    train = chip_smoke.imagenet_train_phase(
        tmx.cpu(), recs, layers=50, image=32, batch=4, dtype="float32",
        timed_batches=2, tol_accuracy=0.0, lr=0.01, blocks=49)
    assert train["steps"] == 16 and train["launches"]["matmul_stats"] == 0
    assert train["fusion"]["pallas_blocks"] == 16
    assert train["queue_parity"]["bit_identical"]
    assert {train["sequential"]["mode"], train["prefetched"]["mode"]} == \
        {"sequential", "prefetch"}
    module = chip_smoke.imagenet_module_phase(tmx.cpu(), recs, layers=50,
                                              image=32, batch=4)
    assert module["fusion"]["layout"] == "NCHW"
    assert module["fusion"]["pallas_blocks"] == 0
