"""The SSD slice on the CPU against the JAX package and ``examples/ssd``:
records made by ``tools.ssd.make_record_file`` equal to
``synth_dataset.make_record_file``'s byte for byte; ``DetRecordIter``
batches equal to the JAX iterator's (shuffle, crop and mirror on); the
mAP metrics on ``tests/test_ssd_e2e.py``'s hand-computed cases; three
``Module`` steps of ``ssd_mini`` at 64 px, batch 2, from the JAX
module's initial parameters (carried by ``convert.from_jax_module``) in
lockstep with the JAX ``Module``; the full-width symbol's anchors and
parameter count; chip_smoke's SSD phases at a tiny size."""
import os
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)

import mxnet_tpu as jmx
from mxnet_tpu.image_det import DetRecordIter as JaxDetRecordIter

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.image_det import DetRecordIter
from mxnet_tpu_torch.tools import ssd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSD = os.path.join(ROOT, "examples", "ssd")
for _p in (SSD, os.path.join(SSD, "symbol"), os.path.join(SSD, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import synth_dataset  # noqa: E402
import ssd_mini  # noqa: E402
from metric import MApMetric as JaxMApMetric  # noqa: E402


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    d = tmp_path_factory.mktemp("ssd")
    path = ssd.make_record_file(str(d / "t.rec"), num_images=10,
                                image_size=64, seed=3)
    jpath = synth_dataset.make_record_file(str(d / "j.rec"), num_images=10,
                                           image_size=64, seed=3)
    return path, jpath


def test_records_equal_the_examples(rec):
    with open(rec[0], "rb") as a, open(rec[1], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("kw", [
    dict(shuffle=False), dict(shuffle=True, rand_mirror=True, seed=1),
    dict(shuffle=True, rand_mirror=True, rand_crop=0.7, seed=5,
         label_pad_width=4)], ids=["plain", "mirror", "crop"])
def test_det_record_iter_equals_jax(rec, kw):
    shape = (3, 48, 48)
    it = DetRecordIter(rec[0], 4, shape, **kw)
    jit = JaxDetRecordIter(rec[0], 4, shape, **kw)
    assert it.provide_label == [tuple(d) for d in jit.provide_label]
    n = 0
    for _epoch in range(2):
        it.reset()
        jit.reset()
        for b, jb in zip(it, jit):
            np.testing.assert_array_equal(b.data[0].asnumpy(),
                                          jb.data[0].asnumpy())
            np.testing.assert_array_equal(b.label[0].asnumpy(),
                                          jb.label[0].asnumpy())
            assert b.pad == jb.pad
            assert b.data[0].context == mx.cpu()
            n += 1
    assert n == 6


def _nd(x):
    return mx.nd.array(np.array(x, "f"), ctx=mx.cpu())


def test_map_metric_hand_computed():
    """``test_ssd_e2e.py``'s case: one TP, one FP, one duplicate."""
    labels = [_nd([[[0, 0.1, 0.1, 0.5, 0.5, 0], [0, 0.6, 0.6, 0.9, 0.9, 0]]])]
    preds = [_nd([[[0, 0.9, 0.1, 0.1, 0.5, 0.5], [0, 0.8, 0.0, 0.0, 0.05,
                                                  0.05],
                   [0, 0.7, 0.12, 0.12, 0.5, 0.5], [-1, 0.0, 0, 0, 0, 0]]])]
    m = ssd.MApMetric(ovp_thresh=0.5)
    m.update(labels, preds)
    assert abs(m.get()[1] - 0.5) < 1e-6
    v07 = ssd.VOC07MApMetric(ovp_thresh=0.5)
    v07.update(labels, preds)
    assert abs(v07.get()[1] - 6.0 / 11.0) < 1e-6


def test_map_metric_missed_class_counts():
    labels = [_nd([[[0, 0.1, 0.1, 0.5, 0.5, 0], [1, 0.6, 0.6, 0.9, 0.9, 0]]])]
    preds = [_nd([[[0, 0.9, 0.1, 0.1, 0.5, 0.5], [-1, 0, 0, 0, 0, 0]]])]
    m = ssd.MApMetric(ovp_thresh=0.5)
    m.update(labels, preds)
    assert abs(m.get()[1] - 0.5) < 1e-6


def test_map_metric_equals_the_examples_on_random_detections():
    rng = np.random.RandomState(0)
    label = -np.ones((3, 4, 6), "f")
    pred = -np.ones((3, 20, 6), "f")
    for i in range(3):
        for j in range(rng.randint(1, 5)):
            c = rng.uniform(0.2, 0.8, 2)
            label[i, j] = [rng.randint(3), *(c - 0.1), *(c + 0.1),
                           rng.rand() < 0.2]
        for j in range(20):
            c = rng.uniform(0.2, 0.8, 2)
            pred[i, j] = [rng.randint(-1, 3), rng.rand(), *(c - 0.12),
                          *(c + 0.1)]
    got = ssd.VOC07MApMetric(class_names=["a", "b", "c"])
    want = JaxMApMetric(class_names=["a", "b", "c"])
    got.update([_nd(label)], [_nd(pred)])
    want.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
    assert got.get()[0] == want.get()[0]
    # the plain metric's values, and VOC07's from its own rule
    plain = ssd.MApMetric(class_names=["a", "b", "c"])
    plain.update([_nd(label)], [_nd(pred)])
    np.testing.assert_allclose(plain.get()[1], want.get()[1], rtol=1e-12)


# ------------------------------------------------- Module steps in lockstep
STEPS = 3
BATCH = 2
SIZE = 64
LR = 0.05
#: per leaf, ||port's update - JAX's|| / ||JAX's update|| of a step taken
#: from the same state (parameters, moving statistics and momentum carried
#: from the JAX module before each step).  The port reads 7.2e-4 in the
#: first step (3e-6 and 1.4e-5 in the next two, where momentum carries
#: most of the update), and only below the first two max pools: the
#: images' flat rectangles give windows of values within rounding of each
#: other, so rounding decides where each package routes a window's
#: gradient (the heads and the last stage read 3e-6 or less).  The free
#: trajectory is chaotic: the hard negatives are the anchors of highest
#: foreground score, scores within rounding of each other swap ranks, and
#: the class targets of free-running steps part by the third step.  A
#: convolution's bias ahead of a BatchNorm has a true gradient of 0 (the
#: normalization removes it): both packages move it from rounding alone
#: (1.8e-7 lr apart), so it is held to TOL_LR of lr a step instead.
TOL = 2e-3
TOL_LR = 1e-5
#: the losses a step (cls_prob, the SmoothL1 terms), of their largest
#: entry: 8.8e-6 and 1.4e-6 read
TOL_OUT = 2e-5
OPT = {"learning_rate": LR, "momentum": 0.9, "wd": 5e-4,
       "rescale_grad": 1.0 / BATCH, "clip_gradient": 4.0}


def _batches(rec):
    it = DetRecordIter(rec, BATCH, (3, SIZE, SIZE), mean_pixels=(128,) * 3,
                       shuffle=True, rand_mirror=True, seed=2)
    return [(b.data[0].asnumpy(), b.label[0].asnumpy())
            for b, _ in zip(it, range(STEPS))], it


def _module(pkg, net, it):
    mod = pkg.mod.Module(net, data_names=("data",), label_names=("label",),
                         context=pkg.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    return mod


def _state(mod):
    return {k: v.asnumpy().copy() for d in mod.get_params()
            for k, v in d.items()}


def _step(pkg, mod, x, y):
    b = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                         label=[pkg.nd.array(y, ctx=pkg.cpu())])
    mod.forward_backward(b)
    mod.update()
    return [o.asnumpy().copy() for o in mod.get_outputs()], _state(mod)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_ssd_mini_steps_match_the_jax_module(rec, tmp_path):
    batches, it = _batches(rec[0])
    jmod = _module(jmx, ssd_mini.get_symbol_train(num_classes=3), it)
    np.random.seed(0)
    jmod.init_params(initializer=jmx.init.Xavier(
        rnd_type="gaussian", factor_type="out", magnitude=2))
    jmod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    tmod = _module(mx, ssd.get_mini_symbol_train(num_classes=3), it)
    arg, aux = convert.from_jax_module(jmod)
    tmod.init_params(arg_params=arg, aux_params=aux)
    tmod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    assert sorted(tmod.get_params()[0]) == sorted(jmod.get_params()[0])
    ahead_of_bn = {k for k in tmod.get_params()[0]
                   if k.startswith("convm") and k.endswith("_bias")}
    states = str(tmp_path / "momentum.states")
    moved = set()
    for step, (x, y) in enumerate(batches):
        before = _state(jmod)
        if step:
            tmod.set_params(*convert.from_jax_module(jmod))
            jmod.save_optimizer_states(states)
            tmod.load_optimizer_states(states)
        assert all(np.array_equal(v, before[k])
                   for k, v in _state(tmod).items())
        touts, tafter = _step(mx, tmod, x, y)
        jouts, jafter = _step(jmx, jmod, x, y)
        # the class targets equal, the losses close, as many detections
        np.testing.assert_array_equal(touts[2], jouts[2])
        assert _rel(touts[0], jouts[0]) <= TOL_OUT, step
        assert _rel(touts[1], jouts[1]) <= TOL_OUT, step
        np.testing.assert_array_equal((touts[3][..., 0] >= 0).sum(1),
                                      (jouts[3][..., 0] >= 0).sum(1))
        worst, in_lr = {}, {}
        for k, want in jafter.items():
            d_want, d_got = want - before[k], tafter[k] - before[k]
            worst[k] = np.linalg.norm(d_got - d_want) / max(
                np.linalg.norm(d_want), 1e-30)
            in_lr[k] = float(np.abs(d_got - d_want).max() / LR)
            moved |= {k} if np.any(d_want != 0) else set()
        held = {k: v for k, v in worst.items() if k not in ahead_of_bn}
        assert max(held.values()) <= TOL, (step, sorted(
            held.items(), key=lambda kv: -kv[1])[:4])
        assert max(in_lr[k] for k in ahead_of_bn) <= TOL_LR, (step, in_lr)
    # every weight but the largest scale's location head (no positive
    # anchor there in these batches) and the fixed gammas moved
    assert {k for k in before if k.endswith("_weight")} - moved \
        <= {"loc_pred2_conv_weight"}


def test_full_width_anchors_and_parameters():
    """SSD300 over VGG16 reduced: 8108 anchors (37^2*4 + 18^2*6 + 9^2*6 +
    5^2*6 + 3^2*4 + 2^2*4) and the parameter count chip_smoke holds the
    card to; the symbol's shapes come from the meta device."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    net = ssd.get_symbol_train(num_classes=20)
    args, outs, _ = net.infer_shape(data=(32, 3, 300, 300),
                                    label=(32, 2, 6))
    assert outs[0] == (32, 21, 8108) and outs[3] == (32, 8108, 6)
    n = sum(int(np.prod(s)) for name, s in zip(net.list_arguments(), args)
            if name not in ("data", "label"))
    assert n == chip_smoke.SSD_PARAMS


def test_chip_smoke_ssd_phases_at_a_tiny_size(tmp_path):
    """ssd_train and ssd_check on the CPU against the CPU: the losses
    fall, every parameter stays finite, no kernel is launched, the check
    reads 0 and the mini SSD's mAP is computed."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    cpu = mx.cpu()
    run = chip_smoke.ssd_train_phase(cpu, str(tmp_path), cfg=dict(
        network="mini", num_classes=3, data_shape=48, batch_size=4,
        images=16, image_size=48, epochs=2, params=None))
    assert run["finite"] and run["batches"] == 8
    assert set(run["kernel_launches"].values()) == {0}
    chk = chip_smoke.ssd_check_phase(cpu, str(tmp_path), cfg=dict(
        chip_smoke.SSD_CHECK, images=8, epochs=2))
    assert chk["step"]["max_rel_update_diff"] == 0.0
    assert 0.0 <= chk["mAP"] <= 1.0
