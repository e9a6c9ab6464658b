"""SSD trained through the Module API from detection records, on one
NVIDIA GPU.

    python -m mxnet_tpu_torch.tools.ssd
    python -m mxnet_tpu_torch.tools.ssd --cpu 1 --network mini \\
        --data-shape 64 --batch-size 4 --images 16 --num-classes 3

The counterpart of ``examples/ssd/`` (``train.py``, ``evaluate.py``,
``metric.py``, ``symbol/ssd_vgg16.py``, ``symbol/ssd_mini.py`` and
``tools/synth_dataset.py``): the same symbols, metrics, record maker,
:func:`train_net` and :func:`evaluate_net`.  The training symbol runs
``MultiBoxPrior`` on each feature scale, ``MultiBoxTarget`` (hard
negative mining at 3:1), ``SoftmaxOutput`` and a SmoothL1 ``MakeLoss``,
and ``MultiBoxDetection`` (NMS over the 400 best) every step.

Its defaults are ``examples/ssd/train.py``'s: ``ssd_vgg16`` (VGG16
reduced with fc6/fc7 as convolutions, six feature scales, 8108 anchors
at 300x300 with the example's sizes and ratios), 20 classes, 300x300,
batch 32, SGD at lr 0.004 with momentum 0.9, wd 5e-4, ``clip_gradient``
4 and ``rescale_grad`` 1/32, ``Xavier(gaussian, out, 2)``, shuffled
records with random mirror, for ``--num-epochs`` (2) epochs of
``--images`` (512) records.  The records are made from a
seed (rectangles of ``--num-classes`` colours on noise, as
``synth_dataset.py`` makes them, at ``--image-size`` pixels), as no
dataset is in the repository.  It runs on ``gpu(0)`` unless ``--cpu 1``
is given and prints one JSON line: the parameter count, the median ms of
a ``fit`` batch past the first epoch (synchronized) and images/s, the
share of a batch spent in ``DetRecordIter.next``, each epoch's
CrossEntropy and SmoothL1, every parameter finite, the peak memory and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import io as _pyio
import json
import logging
import time

import numpy as np

from mxnet_tpu_torch.metric import EvalMetric

__all__ = ["conv_act_layer", "vgg16_reduced", "multi_layer_feature",
           "multibox_layer", "build_train_symbol", "build_symbol",
           "get_symbol_train", "get_symbol", "get_mini_symbol_train",
           "get_mini_symbol", "get_net", "MultiBoxMetric", "MApMetric",
           "VOC07MApMetric", "make_record_file", "train_net",
           "evaluate_net", "CLASS_COLORS", "CLASS_NAMES", "main"]


# ---------------------------------------------------------------- symbols
def conv_act_layer(from_layer, name, num_filter, kernel=(3, 3), pad=(1, 1),
                   stride=(1, 1), act_type="relu"):
    from mxnet_tpu_torch import symbol as sym
    conv = sym.Convolution(data=from_layer, kernel=kernel, pad=pad,
                           stride=stride, num_filter=num_filter,
                           name="conv{}".format(name))
    return sym.Activation(data=conv, act_type=act_type,
                          name="{}{}".format(act_type, name))


def vgg16_reduced(data):
    """VGG16 body with fc6/fc7 as convolutions (fc6 dilated 6); returns
    the named feature maps."""
    from mxnet_tpu_torch import symbol as sym
    body = data
    feat = {}
    for i, (f, n) in enumerate(zip([64, 128, 256, 512, 512],
                                   [2, 2, 3, 3, 3])):
        for j in range(n):
            body = sym.Convolution(data=body, kernel=(3, 3), pad=(1, 1),
                                   num_filter=f,
                                   name="conv%d_%d" % (i + 1, j + 1))
            body = sym.Activation(data=body, act_type="relu",
                                  name="relu%d_%d" % (i + 1, j + 1))
        feat["relu%d_%d" % (i + 1, n)] = body
        if i < 4:
            body = sym.Pooling(data=body, pool_type="max", kernel=(2, 2),
                               stride=(2, 2), name="pool%d" % (i + 1))
        else:
            body = sym.Pooling(data=body, pool_type="max", kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1),
                               name="pool%d" % (i + 1))
    body = sym.Convolution(data=body, kernel=(3, 3), pad=(6, 6),
                           dilate=(6, 6), num_filter=1024, name="fc6")
    body = sym.Activation(data=body, act_type="relu", name="relu6")
    body = sym.Convolution(data=body, kernel=(1, 1), num_filter=1024,
                           name="fc7")
    feat["relu7"] = sym.Activation(data=body, act_type="relu", name="relu7")
    return feat


def multi_layer_feature(feat):
    """relu4_3, relu7 and four more scales of stride 2."""
    layers = [feat["relu4_3"], feat["relu7"]]
    body = feat["relu7"]
    for i, (f1, f2, s) in enumerate([(256, 512, 2), (128, 256, 2),
                                     (128, 256, 2), (128, 256, 2)]):
        body = conv_act_layer(body, "8_%d_1x1" % i, f1, kernel=(1, 1),
                              pad=(0, 0))
        body = conv_act_layer(body, "8_%d_3x3" % i, f2, kernel=(3, 3),
                              pad=(1, 1), stride=(s, s))
        layers.append(body)
    return layers


def multibox_layer(from_layers, num_classes, sizes, ratios):
    """Per-scale location and class heads and their anchors."""
    import mxnet_tpu_torch as mx
    sym = mx.sym
    cls_preds, loc_preds, anchors = [], [], []
    for k, from_layer in enumerate(from_layers):
        size, ratio = sizes[k], ratios[k]
        num_anchors = len(size) + len(ratio) - 1
        loc = sym.Convolution(data=from_layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * 4,
                              name="loc_pred%d_conv" % k)
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_preds.append(sym.Flatten(data=loc))
        cls = sym.Convolution(data=from_layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * (num_classes + 1),
                              name="cls_pred%d_conv" % k)
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_preds.append(sym.Reshape(cls, shape=(0, -1, num_classes + 1)))
        anchor = mx.contrib.sym.MultiBoxPrior(
            from_layer, sizes=tuple(size), ratios=tuple(ratio),
            name="anchor%d" % k)
        anchors.append(sym.Reshape(anchor, shape=(0, -1, 4)))
    loc_preds = sym.Concat(*loc_preds, dim=1, name="multibox_loc_pred")
    cls_preds = sym.Concat(*cls_preds, dim=1, name="multibox_cls_pred")
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1))
    anchors = sym.Concat(*anchors, dim=1, name="multibox_anchors")
    return [loc_preds, cls_preds, anchors]


DEFAULT_SIZES = [[0.1, 0.141], [0.2, 0.272], [0.37, 0.447], [0.54, 0.619],
                 [0.71, 0.79], [0.88, 0.961]]
DEFAULT_RATIOS = [[1, 2, 0.5], [1, 2, 0.5, 3, 1.0 / 3],
                  [1, 2, 0.5, 3, 1.0 / 3], [1, 2, 0.5, 3, 1.0 / 3],
                  [1, 2, 0.5], [1, 2, 0.5]]
MINI_SIZES = [[0.2, 0.3], [0.4, 0.55], [0.7, 0.85]]
MINI_RATIOS = [[1, 2, 0.5]] * 3


def build_train_symbol(layers, num_classes, sizes, ratios,
                       nms_thresh=0.45, nms_topk=400):
    """The training head over feature scales: MultiBoxTarget, the class
    and location losses, the detections (gradients blocked)."""
    import mxnet_tpu_torch as mx
    sym = mx.sym
    label = sym.Variable("label")
    loc_preds, cls_preds, anchors = multibox_layer(
        layers, num_classes, sizes, ratios)
    tmp = mx.contrib.sym.MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=0.5,
        ignore_label=-1, negative_mining_ratio=3, minimum_negative_samples=0,
        negative_mining_thresh=0.5, variances=(0.1, 0.1, 0.2, 0.2),
        name="multibox_target")
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]
    cls_prob = sym.SoftmaxOutput(data=cls_preds, label=cls_target,
                                 ignore_label=-1, use_ignore=True,
                                 multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_diff = loc_target_mask * (loc_preds - loc_target)
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_diff, scalar=1.0),
                            grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    cls_label = sym.BlockGrad(cls_target, name="cls_label")
    det = mx.contrib.sym.MultiBoxDetection(
        cls_prob, loc_preds, anchors, nms_threshold=nms_thresh,
        force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
        nms_topk=nms_topk, name="detection")
    det = sym.BlockGrad(det, name="det_out")
    return sym.Group([cls_prob, loc_loss, cls_label, det])


def build_symbol(layers, num_classes, sizes, ratios, nms_thresh=0.5,
                 force_suppress=False, nms_topk=400):
    """The inference head: softmax over classes, then MultiBoxDetection."""
    import mxnet_tpu_torch as mx
    loc_preds, cls_preds, anchors = multibox_layer(
        layers, num_classes, sizes, ratios)
    cls_prob = mx.sym.SoftmaxActivation(data=cls_preds, mode="channel",
                                        name="cls_prob")
    return mx.contrib.sym.MultiBoxDetection(
        cls_prob, loc_preds, anchors, nms_threshold=nms_thresh,
        force_suppress=force_suppress, variances=(0.1, 0.1, 0.2, 0.2),
        nms_topk=nms_topk, name="detection")


def get_symbol_train(num_classes=20, **kwargs):
    """SSD over VGG16 reduced, for training."""
    from mxnet_tpu_torch import symbol as sym
    layers = multi_layer_feature(vgg16_reduced(sym.Variable("data")))
    return build_train_symbol(layers, num_classes, DEFAULT_SIZES,
                              DEFAULT_RATIOS)


def get_symbol(num_classes=20, nms_thresh=0.5, force_suppress=False,
               nms_topk=400, **kwargs):
    """SSD over VGG16 reduced, for inference."""
    from mxnet_tpu_torch import symbol as sym
    layers = multi_layer_feature(vgg16_reduced(sym.Variable("data")))
    return build_symbol(layers, num_classes, DEFAULT_SIZES, DEFAULT_RATIOS,
                        nms_thresh=nms_thresh, force_suppress=force_suppress,
                        nms_topk=nms_topk)


def _mini_backbone(data):
    """Three conv-BN-ReLU pairs and max pools (32, 64, 128 channels)."""
    from mxnet_tpu_torch import symbol as sym
    body = data
    layers = []
    for i, f in enumerate([32, 64, 128]):
        for part in ("a", "b"):
            name = "m%d_%s" % (i, part)
            body = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                                   num_filter=f, name="conv%s" % name)
            body = sym.BatchNorm(body, name="bn%s" % name)
            body = sym.Activation(body, act_type="relu", name="relu%s" % name)
        body = sym.Pooling(body, pool_type="max", kernel=(2, 2),
                           stride=(2, 2), name="mpool%d" % i)
        layers.append(body)
    return layers[-3:]


def get_mini_symbol_train(num_classes=3, **kwargs):
    """``ssd_mini`` (``examples/ssd/symbol/ssd_mini.py``) for training."""
    from mxnet_tpu_torch import symbol as sym
    return build_train_symbol(_mini_backbone(sym.Variable("data")),
                              num_classes, MINI_SIZES, MINI_RATIOS,
                              nms_thresh=0.45, nms_topk=100)


def get_mini_symbol(num_classes=3, nms_thresh=0.45, **kwargs):
    from mxnet_tpu_torch import symbol as sym
    return build_symbol(_mini_backbone(sym.Variable("data")), num_classes,
                        MINI_SIZES, MINI_RATIOS, nms_thresh=nms_thresh,
                        nms_topk=100)


def get_net(network, num_classes, train=True):
    """``network`` ``"mini"`` or ``"vgg16_reduced"``."""
    if network == "mini":
        return (get_mini_symbol_train if train else get_mini_symbol)(
            num_classes=num_classes)
    return (get_symbol_train if train else get_symbol)(
        num_classes=num_classes)


# ---------------------------------------------------------------- metrics
class MultiBoxMetric(EvalMetric):
    """The training cross-entropy and SmoothL1 over the SSD heads.
    ``batches`` keeps each update's (CE sum, valid count, SmoothL1 sum)
    across resets."""

    def __init__(self, eps=1e-8):
        super().__init__("multibox")
        self.eps = eps
        self.batches = []
        self.reset()

    def reset(self):
        self.ce_sum = 0.0
        self.ce_n = 0
        self.l1_sum = 0.0
        self.l1_n = 0
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        cls_prob = preds[0].asnumpy()
        loc_loss = preds[1].asnumpy()
        cls_label = preds[2].asnumpy()
        valid = int(np.sum(cls_label >= 0))
        flat = cls_label.flatten()
        mask = np.where(flat >= 0)[0]
        idx = flat[mask].astype(np.int64)
        prob = cls_prob.transpose(0, 2, 1).reshape(-1, cls_prob.shape[1])
        prob = prob[mask, idx]
        ce = float((-np.log(prob + self.eps)).sum())
        l1 = float(np.sum(loc_loss))
        self.ce_sum += ce
        self.ce_n += valid
        self.l1_sum += l1
        self.l1_n += valid
        self.num_inst = 1
        self.sum_metric = self.ce_sum / max(self.ce_n, 1)
        self.batches.append((ce, valid, l1))

    def get(self):
        return (["CrossEntropy", "SmoothL1"],
                [self.ce_sum / max(self.ce_n, 1),
                 self.l1_sum / max(self.l1_n, 1)])


class MApMetric(EvalMetric):
    """Mean average precision of detections.  labels: (n, 5|6) [cls,
    xmin, ymin, xmax, ymax, (difficult)]; ``preds[pred_idx]``: (m, 6)
    [cls, score, xmin, ymin, xmax, ymax]."""

    def __init__(self, ovp_thresh=0.5, use_difficult=False,
                 class_names=None, pred_idx=0):
        name = "mAP" if class_names is None else class_names + ["mAP"]
        super().__init__(name if isinstance(name, str) else "mAP")
        self.records = {}
        self.counts = {}
        self.ovp_thresh = ovp_thresh
        self.use_difficult = use_difficult
        self.class_names = class_names
        self.pred_idx = int(pred_idx)

    def reset(self):
        self.records = {}
        self.counts = {}
        self.num_inst = 0
        self.sum_metric = 0.0

    @staticmethod
    def _iou(x, ys):
        ixmin = np.maximum(ys[:, 0], x[0])
        iymin = np.maximum(ys[:, 1], x[1])
        ixmax = np.minimum(ys[:, 2], x[2])
        iymax = np.minimum(ys[:, 3], x[3])
        iw = np.maximum(ixmax - ixmin, 0.0)
        ih = np.maximum(iymax - iymin, 0.0)
        inters = iw * ih
        uni = (x[2] - x[0]) * (x[3] - x[1]) + \
            (ys[:, 2] - ys[:, 0]) * (ys[:, 3] - ys[:, 1]) - inters
        ious = inters / np.maximum(uni, 1e-12)
        ious[uni < 1e-12] = 0
        return ious

    def _gt_count(self, gts):
        if not self.use_difficult and gts.shape[1] >= 6:
            return int(np.sum(gts[:, 5] < 1))
        return gts.shape[0]

    def update(self, labels, preds):
        for i in range(labels[0].shape[0]):
            label = labels[0][i].asnumpy()
            label = label[label[:, 0] >= 0]
            pred = preds[self.pred_idx][i].asnumpy()
            processed = set()
            while pred.shape[0] > 0:
                cid = int(pred[0, 0])
                indices = np.where(pred[:, 0].astype(int) == cid)[0]
                if cid < 0:
                    pred = np.delete(pred, indices, axis=0)
                    continue
                dets = pred[indices]
                pred = np.delete(pred, indices, axis=0)
                processed.add(cid)
                dets = dets[dets[:, 1].argsort()[::-1]]
                records = np.hstack((dets[:, 1][:, np.newaxis],
                                     np.zeros((dets.shape[0], 1))))
                gts = label[label[:, 0].astype(int) == cid]
                if gts.size > 0:
                    found = [False] * gts.shape[0]
                    for j in range(dets.shape[0]):
                        ious = self._iou(dets[j, 2:6], gts[:, 1:5])
                        am = int(np.argmax(ious))
                        if ious[am] > self.ovp_thresh:
                            if (not self.use_difficult and
                                    gts.shape[1] >= 6 and gts[am, 5] > 0):
                                pass        # a difficult gt: neither tp nor fp
                            elif not found[am]:
                                records[j, -1] = 1          # tp
                                found[am] = True
                            else:
                                records[j, -1] = 2          # duplicate: fp
                        else:
                            records[j, -1] = 2
                else:
                    records[:, -1] = 2
                gt_count = self._gt_count(gts)
                records = records[records[:, -1] > 0]
                if records.size > 0:
                    self._insert(cid, records, gt_count)
                elif gt_count > 0:
                    self._insert(cid, np.array([[-1.0, 0.0]]), gt_count)
            # a class with labels and no detection counts with AP 0
            for cid in np.unique(label[:, 0].astype(int)):
                if cid < 0 or cid in processed:
                    continue
                gts = label[label[:, 0].astype(int) == cid]
                gt_count = self._gt_count(gts)
                if gt_count > 0:
                    self._insert(int(cid), np.array([[-1.0, 0.0]]), gt_count)

    def _insert(self, key, records, count):
        if key not in self.records:
            self.records[key] = records
            self.counts[key] = count
        else:
            self.records[key] = np.vstack((self.records[key], records))
            self.counts[key] += count

    def _recall_prec(self, record, count):
        srt = record[record[:, 0].argsort()[::-1]]
        tp = np.cumsum(srt[:, 1].astype(int) == 1)
        fp = np.cumsum(srt[:, 1].astype(int) == 2)
        recall = tp / float(count) if count > 0 else tp * 0.0
        prec = tp.astype(float) / np.maximum(tp + fp, 1)
        return recall, prec

    def _average_precision(self, rec, prec):
        mrec = np.concatenate(([0.0], rec, [1.0]))
        mpre = np.concatenate(([0.0], prec, [0.0]))
        for i in range(mpre.size - 1, 0, -1):
            mpre[i - 1] = max(mpre[i - 1], mpre[i])
        i = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))

    def get(self):
        aps = {}
        for k, v in self.records.items():
            recall, prec = self._recall_prec(v, self.counts[k])
            aps[k] = self._average_precision(recall, prec)
        if not aps:
            return ("mAP", float("nan"))
        mean_ap = float(np.mean(list(aps.values())))
        if self.class_names is None:
            return ("mAP", mean_ap)
        names = [self.class_names[k] if k < len(self.class_names) else str(k)
                 for k in sorted(aps)] + ["mAP"]
        values = [aps[k] for k in sorted(aps)] + [mean_ap]
        return (names, values)


class VOC07MApMetric(MApMetric):
    """11-point interpolated AP."""

    def _average_precision(self, rec, prec):
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else float(np.max(prec[rec >= t]))
            ap += p / 11.0
        return ap


# ---------------------------------------------------------------- records
CLASS_COLORS = [(220, 40, 40), (40, 220, 40), (40, 40, 220)]
CLASS_NAMES = ["red", "green", "blue"]


def class_colors(num_classes):
    """:data:`CLASS_COLORS`, then further colours from a fixed grid."""
    extra = [(r, g, b) for r in (30, 110, 190, 250) for g in (30, 110, 190)
             for b in (60, 160, 250)]
    extra = [c for c in extra if c not in CLASS_COLORS]
    return (CLASS_COLORS + extra)[:num_classes]


def make_record_file(path, num_images=64, image_size=96, max_objects=2,
                     seed=0, num_classes=3):
    """Rectangles of a class's colour on noise, as JPEG detection records
    (``pack_det_label``); with 3 classes the records of
    ``synth_dataset.make_record_file``, byte for byte."""
    from PIL import Image
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.image_det import pack_det_label
    colors = class_colors(num_classes)
    rng = np.random.RandomState(seed)
    w = recordio.MXRecordIO(path, "w")
    try:
        for i in range(num_images):
            img = (rng.rand(image_size, image_size, 3) * 40 + 100).astype(
                np.uint8)
            objs = []
            for _ in range(rng.randint(1, max_objects + 1)):
                cls = rng.randint(len(colors))
                bw = rng.randint(image_size // 4, image_size // 2)
                bh = rng.randint(image_size // 4, image_size // 2)
                x0 = rng.randint(0, image_size - bw)
                y0 = rng.randint(0, image_size - bh)
                img[y0:y0 + bh, x0:x0 + bw] = colors[cls]
                objs.append([cls, x0 / image_size, y0 / image_size,
                             (x0 + bw) / image_size, (y0 + bh) / image_size,
                             0])
            buf = _pyio.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=95)
            w.write(recordio.pack(
                recordio.IRHeader(0, pack_det_label(objs), i, 0),
                buf.getvalue()))
    finally:
        w.close()
    return path


# ------------------------------------------------------------ train, eval
class _TimedIter:
    """A ``DataIter`` whose ``next`` is timed (``seconds``, one entry a
    call)."""

    def __init__(self, it):
        self._it = it
        self.seconds = []

    def __getattr__(self, name):
        return getattr(self._it, name)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        t0 = time.perf_counter()
        try:
            return self._it.next()
        finally:
            self.seconds.append(time.perf_counter() - t0)

    def reset(self):
        self._it.reset()


def train_net(train_rec, network="vgg16_reduced", num_classes=20,
              batch_size=32, data_shape=(3, 300, 300), num_epochs=1,
              lr=0.004, momentum=0.9, wd=5e-4, ctx=None, seed=0,
              model_prefix=None, mean_pixels=(123.68, 116.779, 103.939),
              rand_mirror=True, frequent=20, batch_end_callback=None,
              timed=None, metric=None):
    """``examples/ssd/train.py``'s flow: ``DetRecordIter`` ->
    ``Module.fit`` with :class:`MultiBoxMetric`, on ``ctx`` (default: the
    current context, ``gpu(0)``).  ``batch_end_callback`` runs before the
    Speedometer; ``timed``, a list, receives the :class:`_TimedIter`
    whose ``seconds`` time each ``DetRecordIter.next``; ``metric``: the
    :class:`MultiBoxMetric` to fit with.  Returns the fitted module."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.image_det import DetRecordIter
    net = get_net(network, num_classes, train=True)
    train_iter = DetRecordIter(train_rec, batch_size, data_shape,
                               mean_pixels=mean_pixels, shuffle=True,
                               rand_mirror=rand_mirror, seed=seed)
    if timed is not None:
        train_iter = _TimedIter(train_iter)
        timed.append(train_iter)
    mod = mx.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=ctx or mx.current_context())
    callbacks = [batch_end_callback] if batch_end_callback else []
    mod.fit(train_iter,
            eval_metric=metric or MultiBoxMetric(),
            optimizer="sgd",
            optimizer_params={"learning_rate": lr, "momentum": momentum,
                              "wd": wd, "rescale_grad": 1.0 / batch_size,
                              "clip_gradient": 4.0},
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="out", magnitude=2),
            num_epoch=num_epochs,
            batch_end_callback=callbacks + [
                mx.callback.Speedometer(batch_size, frequent)])
    if model_prefix:
        mod.save_checkpoint(model_prefix, num_epochs)
    return mod


def evaluate_net(module_or_params, val_rec, num_classes, network="mini",
                 batch_size=8, data_shape=(3, 96, 96), ctx=None,
                 ovp_thresh=0.5, use_voc07=True, class_names=None,
                 mean_pixels=(123.68, 116.779, 103.939)):
    """Score a trained SSD on a detection ``.rec`` with VOC mAP; returns
    ``Module.score``'s (name, value) pairs.  ``module_or_params``: a
    fitted training Module (its weights go onto the inference symbol) or
    ``(arg_params, aux_params)``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.image_det import DetRecordIter
    net = get_net(network, num_classes, train=False)
    if hasattr(module_or_params, "get_params"):
        arg_params, aux_params = module_or_params.get_params()
    else:
        arg_params, aux_params = module_or_params
    val_iter = DetRecordIter(val_rec, batch_size, data_shape,
                             mean_pixels=mean_pixels)
    mod = mx.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=ctx or mx.current_context())
    mod.bind(data_shapes=val_iter.provide_data,
             label_shapes=val_iter.provide_label, for_training=False)
    mod.set_params(arg_params, aux_params, allow_missing=False)
    metric = (VOC07MApMetric if use_voc07 else MApMetric)(
        ovp_thresh=ovp_thresh, class_names=class_names)
    return mod.score(val_iter, metric)


def param_count(mod):
    return int(sum(v.size for v in mod.get_params()[0].values()))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="train SSD on made records")
    p.add_argument("--network", default="vgg16_reduced",
                   choices=["vgg16_reduced", "mini"])
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--data-shape", type=int, default=300)
    p.add_argument("--num-epochs", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.004)
    p.add_argument("--images", type=int, default=512,
                   help="records made for training")
    p.add_argument("--image-size", type=int, default=300,
                   help="side of the made images, in pixels")
    p.add_argument("--max-objects", type=int, default=2)
    p.add_argument("--rec", default=None,
                   help="the .rec to make (default: a temporary file)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", type=int, default=0,
                   help="1 to train on the CPU (default: gpu(0))")
    return p.parse_args(argv)


def run(a, ctx, rec):
    """:func:`train_net` with the arguments ``a`` on ``ctx`` from the
    records ``rec``; the JSON line's fields and the module."""
    import torch
    on_card = ctx.device_type == "gpu"
    if on_card:
        dev = ctx.torch_device()
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    stamps, timed = [], []

    def stamp(param):
        if on_card:
            torch.cuda.synchronize(dev)
        stamps.append((param.epoch, time.perf_counter()))

    metric = MultiBoxMetric()
    t0 = time.perf_counter()
    mod = train_net(rec, a.network, a.num_classes, a.batch_size,
                    (3, a.data_shape, a.data_shape), a.num_epochs, lr=a.lr,
                    ctx=ctx, seed=a.seed, batch_end_callback=stamp,
                    timed=timed, metric=metric)
    fit_s = time.perf_counter() - t0
    per_epoch = len(stamps) // a.num_epochs
    batch_ms = [(t - s) * 1e3 for (e, t), (_e, s) in
                zip(stamps[1:], stamps[:-1]) if e == _e]
    later = [(t - s) * 1e3 for (e, t), (_e, s) in
             zip(stamps[1:], stamps[:-1]) if e == _e and e > 0] or batch_ms
    median = float(np.median(later))
    next_s = timed[0].seconds
    epochs = []
    for e in range(a.num_epochs):
        b = metric.batches[e * per_epoch:(e + 1) * per_epoch]
        n = max(sum(v for _c, v, _l in b), 1)
        epochs.append({"CrossEntropy": sum(c for c, _v, _l in b) / n,
                       "SmoothL1": sum(l for _c, _v, l in b) / n})
    args, aux = mod.get_params()
    out = {"network": a.network, "num_classes": a.num_classes,
           "data_shape": a.data_shape, "batch_size": a.batch_size,
           "epochs": a.num_epochs, "images": a.images,
           "params": param_count(mod), "batches": len(stamps),
           "batch_ms": batch_ms, "median_batch_ms": median,
           "images_per_s": a.batch_size / median * 1e3,
           "next_ms_median": float(np.median(next_s)) * 1e3,
           "next_share": float(np.median(next_s)) * 1e3 / median,
           "fit_s": fit_s, "epoch_losses": epochs,
           "finite": bool(all(np.isfinite(v.asnumpy()).all()
                              for d in (args, aux) for v in d.values())),
           "context": str(ctx)}
    if on_card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    return out, mod


def main(argv=None):
    import os
    import tempfile
    import torch
    import mxnet_tpu_torch as mx
    from . import nvidia_smi
    a = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if a.cpu:
        ctx = mx.cpu()
    elif not torch.cuda.is_available():
        raise SystemExit("ssd: no CUDA device; pass --cpu 1 to train on the "
                         "CPU")
    else:
        ctx = mx.gpu(0)
    with tempfile.TemporaryDirectory() as d:
        rec = a.rec or os.path.join(d, "train.rec")
        t0 = time.perf_counter()
        make_record_file(rec, a.images, a.image_size, a.max_objects,
                         seed=a.seed, num_classes=a.num_classes)
        records_s = time.perf_counter() - t0
        out, _mod = run(a, ctx, rec)
    out["records_s"] = records_s
    if ctx.device_type == "gpu":
        out["device"] = torch.cuda.get_device_name(ctx.device_id)
        out["nvidia_smi"] = nvidia_smi()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
