"""The Faster R-CNN slice on the CPU against ``examples/rcnn`` (the JAX
package): ``generate_anchors``, ``bbox_transform``, ``bbox_pred``,
``nms`` and ``assign_anchor`` equal to the example's; ``AnchorLoader``'s
batches equal; two ``fit`` steps of the training symbol (Proposal, the
``proposal_target`` Custom op, ROIPooling) in lockstep with the JAX
``Module`` from its initial parameters; the test symbol's shapes on
``meta``; chip_smoke's detection_ops and rcnn_train phases at a tiny
size."""
import os
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (xdist workers share the cores)

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.tools import rcnn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCNN = os.path.join(ROOT, "examples", "rcnn")
if RCNN not in sys.path:
    sys.path.insert(0, RCNN)

import rcnn_lib  # noqa: E402
import symbol_rcnn  # noqa: E402
import train_end2end  # noqa: E402


def test_anchors_and_box_transforms_equal_the_examples():
    for args in ((16, (0.5, 1, 2), (8, 16, 32)), (8, (1.0,), (2, 4))):
        np.testing.assert_array_equal(rcnn.generate_anchors(*args),
                                      rcnn_lib.generate_anchors(*args))
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 40, (20, 2))
    ex = np.concatenate([a, a + rng.uniform(5, 30, (20, 2))], 1).astype("f")
    gt = np.concatenate([a + 2, a + rng.uniform(5, 30, (20, 2))], 1) \
        .astype("f")
    np.testing.assert_array_equal(rcnn.bbox_transform(ex, gt),
                                  rcnn_lib.bbox_transform(ex, gt))
    deltas = rng.normal(0, 0.3, (20, 12)).astype("f")
    np.testing.assert_array_equal(rcnn.bbox_pred(ex, deltas),
                                  rcnn_lib.bbox_pred(ex, deltas))
    np.testing.assert_array_equal(rcnn.clip_boxes(ex * 3, (50, 60)),
                                  rcnn_lib.clip_boxes(ex * 3, (50, 60)))
    dets = np.concatenate([ex, rng.rand(20, 1).astype("f")], 1)
    for thresh in (0.1, 0.3, 0.7):
        assert rcnn.nms(dets, thresh) == rcnn_lib.nms(dets, thresh)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_anchor_equals_the_examples(seed):
    images, gts = rcnn.synthetic_detection(4, seed=seed)
    labels = []
    for gt in gts:
        got = rcnn.assign_anchor((12, 12), gt, (96, 96), 8, (2, 4), (1.0,),
                                 rng=np.random.RandomState(seed))
        want = rcnn_lib.assign_anchor((12, 12), gt, (96, 96), 8, (2, 4),
                                      (1.0,),
                                      rng=np.random.RandomState(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        labels.append(got[0])
    assert (np.array(labels) == 1).any() and (np.array(labels) == 0).any()
    want_images, want_gts = train_end2end.synthetic_detection(4, seed=seed)
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(gts, want_gts)


def _loader(pkg_loader, n=6):
    images, gts = rcnn.synthetic_detection(n, seed=0)
    return pkg_loader(images, gts, shuffle=True, seed=1)


def _numpy_batches(it, n):
    out = []
    for b, _ in zip(it, range(n)):
        out.append(([d.asnumpy() for d in b.data],
                    [lab.asnumpy() for lab in b.label]))
    return out


def test_anchor_loader_equals_the_examples():
    got = _numpy_batches(_loader(rcnn.AnchorLoader), 6)
    want = _numpy_batches(_loader(train_end2end.AnchorLoader), 6)
    for (gd, gl), (wd, wl) in zip(got, want):
        for g, w in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(g, w)


STEPS = 2
LR = 2e-3
OPT = {"learning_rate": LR, "momentum": 0.9, "wd": 5e-4,
       "clip_gradient": 5.0}
#: per leaf, ||port's update - JAX's|| / ||JAX's update|| of a step from
#: the same state (parameters and momentum carried from the JAX module):
#: the port reads 2.5e-5 and 1.3e-5
TOL = 1e-4
#: the four losses' outputs, of their largest entry: 1.1e-6 read
TOL_OUT = 1e-5


def _module(pkg, net, it):
    mod = pkg.mod.Module(net, context=pkg.cpu(),
                         data_names=("data", "im_info", "gt_boxes"),
                         label_names=("label", "bbox_target", "bbox_weight"))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    return mod


def _state(mod):
    return {k: v.asnumpy().copy() for d in mod.get_params()
            for k, v in d.items()}


def _step(pkg, mod, batch):
    data, label = batch
    b = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu()) for x in data],
                         label=[pkg.nd.array(x, ctx=pkg.cpu())
                                for x in label])
    mod.forward_backward(b)
    mod.update()
    return [o.asnumpy().copy() for o in mod.get_outputs()], _state(mod)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_fit_steps_match_the_jax_module(tmp_path):
    """Two SGD steps of ``train_end2end.train``'s module, each from the
    JAX module's state: the sampled labels (the Custom op's output) equal,
    the four losses' outputs and every leaf's update close."""
    it = _loader(rcnn.AnchorLoader)
    batches = _numpy_batches(it, STEPS)
    jmod = _module(jmx, symbol_rcnn.get_rcnn_train(3), it)
    np.random.seed(0)
    jmod.init_params(initializer=jmx.init.Xavier())
    jmod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    tmod = _module(mx, rcnn.get_rcnn_train(3), it)
    arg, aux = convert.from_jax_module(jmod)
    tmod.init_params(arg_params=arg, aux_params=aux)
    tmod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    states = str(tmp_path / "momentum.states")
    calls = mx.operator.Custom.host_calls
    for step, batch in enumerate(batches):
        before = _state(jmod)
        if step:
            tmod.set_params(*convert.from_jax_module(jmod))
            jmod.save_optimizer_states(states)
            tmod.load_optimizer_states(states)
        touts, tafter = _step(mx, tmod, batch)
        jouts, jafter = _step(jmx, jmod, batch)
        np.testing.assert_array_equal(touts[4], jouts[4])
        for i in range(4):
            assert _rel(touts[i], jouts[i]) <= TOL_OUT, (step, i)
        worst = {}
        for k, want in jafter.items():
            d_want, d_got = want - before[k], tafter[k] - before[k]
            worst[k] = np.linalg.norm(d_got - d_want) / max(
                np.linalg.norm(d_want), 1e-30)
        assert max(worst.values()) <= TOL, (step, sorted(
            worst.items(), key=lambda kv: -kv[1])[:4])
    # one host round trip a step: the forward (no input needs a gradient)
    assert mx.operator.Custom.host_calls - calls == STEPS


def test_test_symbol_shapes_on_meta():
    net = rcnn.get_rcnn_test(3)
    _, outs, _ = net.infer_shape(data=(1, 1, 96, 96), im_info=(1, 3))
    assert outs == [(32, 5), (32, 3), (32, 12)]
    net = rcnn.get_rcnn_train(3)
    calls = mx.operator.Custom.host_calls
    args, outs, _ = net.infer_shape(data=(1, 1, 96, 96), im_info=(1, 3),
                                    gt_boxes=(1, 4, 5), label=(1, 2, 12, 12),
                                    bbox_target=(1, 8, 12, 12),
                                    bbox_weight=(1, 8, 12, 12))
    assert mx.operator.Custom.host_calls == calls
    assert outs[2] == (32, 3) and outs[4] == (32,)


def test_chip_smoke_detection_phases_at_a_tiny_size():
    """detection_ops (two SSD feature maps, batch 2) and rcnn_train (one
    epoch of 24 images) on the CPU against the CPU: every reading 0, every
    integer output equal, the losses falling, one host round trip a step,
    no kernel launched."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mxnet_tpu_torch.tools.op_corpus import DETECTION_OPS
    ops = chip_smoke.detection_ops_phase("cpu", "cpu", batch=2, maps=(6, 3))
    assert ops["corpus"]["ops"] == sorted(DETECTION_OPS)
    assert ops["corpus"]["worst"] == 0.0
    mb = ops["multibox"]
    assert mb["anchors"] == 6 * 6 * 4 + 3 * 3 * 6
    assert mb["target_cls_equal"] and mb["detection_ids_equal"]
    assert mb["positives"] > 0 and mb["kept"] > 0
    assert set(ops["kernel_launches"].values()) == {0}
    run = chip_smoke.rcnn_train_phase(mx.cpu(), cfg=dict(
        epochs=1, images=24, test_images=4))
    assert run["steps"] == 24 and run["finite"]
    assert set(run["kernel_launches"].values()) == {0}
