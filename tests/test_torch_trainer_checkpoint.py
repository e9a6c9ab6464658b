"""The port's ``ShardedTrainer`` checkpoints against the JAX trainer's, on
the CPU, on a small NHWC net (convolutions, BatchNorm, pooling, a
classifier).

A checkpoint with optimizer states written by one package loads in the
other, and the next three steps of both trainers agree within
``test_torch_trainer.py``'s and ``test_torch_nhwc_trainer.py``'s
tolerances (losses to 1e-4 relative, parameters and moving statistics by
the norm of their difference to 1e-4), under SGD with momentum and under
Adam, whose bias correction reads the saved update count.  A run saved
at step 2 and resumed through ``restore_data_iter`` in a fresh trainer
equals the uninterrupted five-step run bit for bit; a SIGTERM sent from
inside the update loop saves the state after the step, and one sent
between steps (after the last, with a batch fetched and not stepped, or
after a load and no step) saves the last step's (or the loaded) state
and data state at once; ``tools.fit``'s
fused ``--model-prefix``/``--load-epoch`` round trip runs at a tiny
size."""
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import build_mesh as jax_build_mesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io_resume, resilience
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import ShardedTrainer, build_mesh

BATCH = 4
CLASSES = 5
SHAPES = dict(data_shapes={"data": (BATCH, 3, 8, 8)},
              label_shapes={"softmax_label": (BATCH,)})
OPTS = {"sgd": dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
                    weight_decay=1e-4),
        "adam": dict(optimizer="adam", learning_rate=0.01,
                     weight_decay=1e-4)}
TOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_stash():
    """Both packages stash a loaded checkpoint's data state for the next
    fit in the process: clear both after each test."""
    yield
    jmx.io_resume.clear_pending()
    io_resume.clear_pending()
    io_resume.track(None)


def net(sym):
    data = sym.Variable("data")
    x = sym.Convolution(data, num_filter=6, kernel=(3, 3), pad=(1, 1),
                        no_bias=True, name="c1")
    x = sym.BatchNorm(x, fix_gamma=False, name="bn1")
    x = sym.Activation(x, act_type="relu", name="r1")
    x = sym.Convolution(x, num_filter=8, kernel=(1, 1), no_bias=True,
                        name="c2")
    x = sym.BatchNorm(x, fix_gamma=False, name="bn2")
    x = sym.Activation(x, act_type="relu", name="r2")
    x = sym.Pooling(x, kernel=(8, 8), global_pool=True, pool_type="avg",
                    name="pool")
    x = sym.FullyConnected(sym.Flatten(x), num_hidden=CLASSES, name="fc")
    return sym.SoftmaxOutput(x, name="softmax")


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"data": rng.uniform(-1, 1, (BATCH, 3, 8, 8)).astype(np.float32),
             "softmax_label": rng.randint(0, CLASSES, BATCH)
             .astype(np.float32)} for _ in range(n)]


def _jax(opt):
    np.random.seed(0)
    return JaxTrainer(net(jmx.sym), jax_build_mesh(n_devices=1),
                      layout="NHWC", **SHAPES, **OPTS[opt])


def _port(opt, seed=3):
    return ShardedTrainer(net(tmx.sym), build_mesh(devices=[tmx.cpu()]),
                          layout="NHWC", seed=seed, **SHAPES, **OPTS[opt])


def _np(d):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in d.items()}


def _rel(got, want):
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([want[k].ravel() for k in sorted(want)])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _continue_together(jt, pt, batches):
    jl = [float(jt.step(b)) for b in batches]
    pl = [float(pt.step(b)) for b in batches]
    np.testing.assert_allclose(pl, jl, rtol=TOL)
    assert _rel(_np(pt.params), _np(jt.params)) <= TOL
    assert _rel(_np(pt.aux), _np(jt.aux)) <= TOL
    slots = {"%s/%d" % (k, i): s for k, v in jt.opt_state.items()
             for i, s in enumerate(v)}
    mine = {"%s/%d" % (k, i): s for k, v in pt.opt_state.items()
            for i, s in enumerate(v)}
    assert _rel(_np(mine), _np(slots)) <= TOL


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_jax_checkpoint_continues_in_the_port(opt, tmp_path):
    batches = _batches(5)
    jt = _jax(opt)
    for b in batches[:2]:
        jt.step(b)
    prefix = str(tmp_path / "jax")
    jt.save_checkpoint(prefix, 2, save_optimizer_states=True)
    pt = _port(opt)
    pt.load_checkpoint(prefix, 2, load_optimizer_states=True)
    for mine, theirs in ((pt.params, jt.params), (pt.aux, jt.aux)):
        for k, v in theirs.items():
            assert np.array_equal(mine[k].numpy(), np.asarray(v)), k
    assert pt.optimizer.begin_num_update == 2
    _continue_together(jt, pt, batches[2:])


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_port_checkpoint_continues_in_jax(opt, tmp_path):
    batches = _batches(5)
    pt = _port(opt)
    for b in batches[:2]:
        pt.step(b)
    prefix = str(tmp_path / "port")
    pt.save_checkpoint(prefix, 2, save_optimizer_states=True)
    doc = jmx.resilience.verify_manifest(prefix, 2)
    assert doc["format"] == 2 and doc["meta"]["mesh"]["world"] == 1
    assert set(doc["files"]) == {"port-0002.params", "port-0002.states"}
    jt = _jax(opt)
    jt.load_checkpoint(prefix, 2, load_optimizer_states=True)
    assert jt.optimizer.begin_num_update == 2
    _continue_together(jt, pt, batches[2:])


def test_the_mesh_descriptor_is_the_jax_trainers():
    jt, pt = _jax("sgd"), _port("sgd")
    assert pt.mesh_descriptor() == jt.mesh_descriptor()


def _iter(batches):
    return tmx.io.NDArrayIter(
        np.concatenate([b["data"] for b in batches]),
        np.concatenate([b["softmax_label"] for b in batches]),
        batch_size=BATCH)


def _run(trainer, it, steps, prefetch):
    source = tmx.io.DevicePrefetchIter(it, trainer.put_batch, depth=2) \
        if prefetch else it
    losses = []
    for _ in range(steps):
        b = next(source)
        if not prefetch:
            b = trainer.put_batch({"data": b.data[0].data,
                                   "softmax_label": b.label[0].data})
        losses.append(float(trainer.step(b)))
    return losses, source


def _state(trainer):
    out = {"p:" + k: v.clone() for k, v in trainer.params.items()}
    out.update({"a:" + k: v.clone() for k, v in trainer.aux.items()})
    out.update({"s%d:%s" % (i, k): s.clone()
                for k, v in trainer.opt_state.items()
                for i, s in enumerate(v)})
    return out


@pytest.mark.parametrize("opt,prefetch", [("sgd", True), ("adam", True),
                                          ("adam", False)])
def test_split_run_equals_the_uninterrupted_one(opt, prefetch, tmp_path):
    batches = _batches(7, seed=1)
    ref = _port(opt)
    ref_losses, ref_source = _run(ref, _iter(batches), 5, prefetch)

    first = _port(opt)
    it = _iter(batches)
    assert first.restore_data_iter(it) is None    # nothing stashed: tracks
    losses, source = _run(first, it, 2, prefetch)
    if prefetch:
        first.restore_data_iter(source)           # track the wrapper
    prefix = str(tmp_path / "split")
    first.save_checkpoint(prefix, 2, save_optimizer_states=True)
    entry = resilience.load_manifest(prefix, 2)["meta"]["data_state"]
    assert entry["state"] == {"v": 1, "kind": "ndarray", "epoch": 0,
                              "offset": 2 * BATCH,
                              "num_data": 7 * BATCH}

    second = _port(opt, seed=11)
    assert second.load_latest_checkpoint(
        prefix, load_optimizer_states=True) == 2
    it2 = _iter(batches)
    source2 = tmx.io.DevicePrefetchIter(it2, second.put_batch, depth=2) \
        if prefetch else it2
    assert second.restore_data_iter(source2)["state"] == entry["state"]
    for _ in range(3):
        b = next(source2)
        if not prefetch:
            b = second.put_batch({"data": b.data[0].data,
                                  "softmax_label": b.label[0].data})
        losses.append(float(second.step(b)))
    for s in (ref_source, source, source2):
        if prefetch:
            s.close()
    assert losses == ref_losses
    got, want = _state(second), _state(ref)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("exit_process", [False, True])
def test_sigterm_inside_the_update_loop_saves_the_state_after_the_step(
        exit_process, tmp_path):
    batches = _batches(3)
    pt = _port("adam")
    prefix = str(tmp_path / "pre")
    old = signal.getsignal(signal.SIGTERM)
    try:
        handler = pt.install_preemption_handler(prefix,
                                                exit_process=exit_process)
        pt.step(batches[0])
        pt.step(batches[1])
        rule = pt._update_rule
        seen = []

        def rule_with_signal(w, g, s, lr, wd, t):
            if not seen:
                seen.append(t)
                os.kill(os.getpid(), signal.SIGTERM)
                assert handler.pending and not handler.triggered
            rule(w, g, s, lr, wd, t)

        pt._refresh_rule = lambda: setattr(pt, "_update_rule",
                                           rule_with_signal)
        if exit_process:
            with pytest.raises(SystemExit) as e:
                pt.step(batches[2])
            assert e.value.code == 0
        else:
            pt.step(batches[2])
        assert seen == [3] and handler.triggered and not handler.pending
    finally:
        signal.signal(signal.SIGTERM, old)
    assert resilience.verify_manifest(prefix, 3) is not None
    files = tmx.nd.load("%s-0003.params" % prefix, ctx=tmx.cpu())
    states = tmx.nd.load("%s-0003.states" % prefix, ctx=tmx.cpu())
    for k, v in pt.params.items():
        assert torch.equal(files["arg:" + k].data, v)
    for k, v in pt.aux.items():
        assert torch.equal(files["aux:" + k].data, v)
    for k, slots in pt.opt_state.items():
        for i, s in enumerate(slots):
            assert torch.equal(states["slot%d:%s" % (i, k)].data, s)
    assert int(states["meta:num_update"].data[0]) == 3


def _signal_self(handler):
    """SIGTERM to this process; the handler runs at the next bytecode."""
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.monotonic() + 10
    while not handler.triggered and time.monotonic() < deadline:
        time.sleep(0.001)


@pytest.mark.parametrize("fetched", [False, True])
def test_sigterm_between_steps_saves_the_last_step_at_once(fetched,
                                                            tmp_path):
    batches = _batches(5, seed=2)
    pt = _port("sgd")
    prefix = str(tmp_path / "between")
    source = tmx.io.DevicePrefetchIter(_iter(batches), pt.put_batch,
                                       depth=2)
    old = signal.getsignal(signal.SIGTERM)
    try:
        handler = pt.install_preemption_handler(prefix)
        pt.restore_data_iter(source)
        for _ in range(3):
            pt.step(next(source))
        after = _state(pt)
        if fetched:
            next(source)              # fetched, never stepped
        with pytest.raises(SystemExit) as e:
            _signal_self(handler)
        assert e.value.code == 0 and handler.triggered
    finally:
        signal.signal(signal.SIGTERM, old)
        source.close()
    doc = resilience.verify_manifest(prefix, 3)
    state = doc["meta"]["data_state"]["state"]
    assert state["offset"] == 3 * BATCH
    files = tmx.nd.load("%s-0003.params" % prefix, ctx=tmx.cpu())
    states = tmx.nd.load("%s-0003.states" % prefix, ctx=tmx.cpu())
    got = {"p:" + k[4:]: v.data for k, v in files.items()
           if k.startswith("arg:")}
    got.update({"a:" + k[4:]: v.data for k, v in files.items()
                if k.startswith("aux:")})
    got.update({"s%s:%s" % (k.split(":", 1)[0][4:], k.split(":", 1)[1]):
                v.data for k, v in states.items() if k.startswith("slot")})
    assert sorted(got) == sorted(after)
    assert all(torch.equal(got[k], after[k]) for k in after)
    fresh = _iter(batches)
    io_resume.restore_iterator(fresh, state)
    assert np.array_equal(next(fresh).data[0].asnumpy(),
                          batches[3]["data"])


def test_sigterm_after_a_load_and_no_step_saves_the_loaded_state(
        tmp_path):
    batches = _batches(3, seed=4)
    pt = _port("sgd")
    it = _iter(batches)
    pt.restore_data_iter(it)
    pt.step(pt.put_batch({"data": batches[0]["data"],
                          "softmax_label": batches[0]["softmax_label"]}))
    next(it)
    first = str(tmp_path / "first")
    pt.save_checkpoint(first, 1, save_optimizer_states=True)
    saved = resilience.load_manifest(first, 1)
    other = _port("sgd", seed=5)
    other.load_checkpoint(first, 1, load_optimizer_states=True)
    second = str(tmp_path / "second")
    old = signal.getsignal(signal.SIGTERM)
    try:
        handler = other.install_preemption_handler(second,
                                                   exit_process=False)
        _signal_self(handler)
        assert handler.triggered and not handler.pending
    finally:
        signal.signal(signal.SIGTERM, old)
    doc = resilience.verify_manifest(second, 1)
    assert doc["meta"]["data_state"] == saved["meta"]["data_state"]
    assert doc["meta"]["data_state"]["state"]["offset"] == BATCH
    assert {k: v["crc32"] for k, v in doc["arrays"].items()} == \
        {k: v["crc32"] for k, v in saved["arrays"].items()}


def test_a_failed_load_leaves_the_trainer_as_it_was(tmp_path):
    pt = _port("sgd")
    pt.step(_batches(1)[0])
    prefix = str(tmp_path / "m")
    pt.save_checkpoint(prefix, 1)            # no .states
    other = _port("sgd", seed=9)
    before = _state(other)
    with pytest.raises(MXNetError, match="states file"):
        other.load_checkpoint(prefix, 1, load_optimizer_states=True)
    after = _state(other)
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_another_world_size_raises(tmp_path):
    pt = _port("sgd")
    prefix = str(tmp_path / "w")
    pt.save_checkpoint(prefix, 1)
    path = resilience.manifest_path(prefix, 1)
    doc = json.load(open(path))
    doc["meta"]["mesh"]["world"] = 4
    json.dump(doc, open(path, "w"))
    with pytest.raises(MXNetError, match="not yet ported"):
        pt.load_checkpoint(prefix, 1)


def test_a_corrupt_newest_epoch_falls_back(tmp_path):
    pt = _port("sgd")
    prefix = str(tmp_path / "f")
    batches = _batches(2)
    pt.step(batches[0])
    pt.save_checkpoint(prefix, 1, save_optimizer_states=True)
    one = _state(pt)
    pt.step(batches[1])
    pt.save_checkpoint(prefix, 2, save_optimizer_states=True)
    with open("%s-0002.params" % prefix, "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\x00\x01\x02\x03")        # same size, bad CRC
    other = _port("sgd", seed=5)
    assert other.load_latest_checkpoint(prefix, True) == 1
    got = _state(other)
    assert all(torch.equal(got[k], one[k]) for k in one)


@pytest.mark.parametrize("opt", ["dcasgd", "sgld", "ftrl", "test"])
def test_unfused_optimizers_raise_in_both_trainers(opt):
    with pytest.raises(jmx.base.MXNetError, match="no fused"):
        JaxTrainer(net(jmx.sym), jax_build_mesh(n_devices=1), **SHAPES,
                   optimizer=opt)
    with pytest.raises(MXNetError, match="no fused"):
        ShardedTrainer(net(tmx.sym), build_mesh(devices=[tmx.cpu()]),
                       **SHAPES, optimizer=opt)


def test_fit_fused_checkpoint_round_trip(tmp_path):
    from mxnet_tpu_torch.tools import train_imagenet
    from mxnet_tpu_torch.tools.io_train_bench import make_class_rec
    rec = str(tmp_path / "t.rec")
    make_class_rec(rec, 2 * BATCH, size=20, classes=4, seed=0)
    prefix = str(tmp_path / "fit")
    argv = ["--cpu", "1", "--network", "resnet", "--num-layers", "8",
            "--image-shape", "3,16,16", "--batch-size", str(BATCH),
            "--data-train", rec, "--data-nthreads", "1", "--dtype",
            "float32", "--fused", "1", "--lr", "0.05", "--disp-batches",
            "0", "--model-prefix", prefix]
    first = train_imagenet.main(argv + ["--num-epochs", "1"])
    assert first["epochs"][0]["checkpoint"]["epoch"] == 1
    doc = resilience.verify_manifest(prefix, 1)
    assert set(doc["files"]) == {"fit-0001.params", "fit-0001.states"}
    second = train_imagenet.main(argv + ["--num-epochs", "2",
                                         "--load-epoch", "1"])
    assert [e["epoch"] for e in second["epochs"]] == [1]
    assert len(second["losses"]) == 2 and np.isfinite(second["losses"]).all()
    assert resilience.verify_manifest(prefix, 2) is not None
    assert tmx.model.find_latest_checkpoint(prefix, True) == 2
