"""Faster R-CNN trained end to end through the Module API, on one NVIDIA
GPU.

    python -m mxnet_tpu_torch.tools.rcnn
    python -m mxnet_tpu_torch.tools.rcnn --cpu 1 --images 8 --test-images 4

The counterpart of ``examples/rcnn/`` (``rcnn_lib.py``,
``symbol_rcnn.py`` and ``train_end2end.py``): the same anchors, box
transforms, RPN anchor targets (:func:`assign_anchor`, on the host per
image, as the reference's ``AnchorLoader`` computes them), the
``proposal_target`` ``CustomOp`` (registered with the port's
``mx.operator``), the symbols, :func:`train`, :func:`detect` and
:func:`evaluate`.  A training step runs the stride-8 trunk, the RPN's
softmax and SmoothL1 losses, ``Proposal`` (NMS over the 400 best
anchors), ``proposal_target`` on the host (one round trip a step),
``ROIPooling`` of 32 rois and the Fast R-CNN heads.

Its configuration is the example's: 96x96 grey images of rectangles
whose intensity gives the class (2 classes and background), one image a
batch, anchors of scales 2 and 4 at stride 8, SGD at lr 2e-3 with
momentum 0.9, wd 5e-4 and ``clip_gradient`` 5, ``Xavier()``, 200
training images shuffled and 50 test images.  It runs on ``gpu(0)``
unless ``--cpu 1`` is given and prints one JSON line: each epoch's
losses and accuracies, the median ms of a step past the first ten
(synchronized), the ``Custom`` op's host round trips a step, the mAP at
IoU 0.5 on the test images, every parameter finite, the peak memory and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np

from mxnet_tpu_torch import operator as _operator
from mxnet_tpu_torch.metric import EvalMetric as _EvalMetric
from mxnet_tpu_torch.io import DataIter as _DataIter

__all__ = ["generate_anchors", "bbox_transform", "bbox_pred", "clip_boxes",
           "iou_matrix", "nms", "assign_anchor", "ProposalTarget",
           "ProposalTargetProp", "get_trunk", "rpn_heads", "rcnn_heads",
           "get_rcnn_train", "get_rcnn_test", "synthetic_detection",
           "AnchorLoader", "RPNAccuracy", "RCNNAccuracy", "RCNNLosses",
           "train", "detect", "evaluate", "main"]


# -------------------------------------------------------------- anchors
def generate_anchors(base_size=16, ratios=(0.5, 1, 2), scales=(8, 16, 32)):
    """Window-centred anchors, ratio-major then scale."""
    base = np.array([0, 0, base_size - 1, base_size - 1], np.float32)
    w, h = base[2] - base[0] + 1, base[3] - base[1] + 1
    cx, cy = base[0] + 0.5 * (w - 1), base[1] + 0.5 * (h - 1)
    anchors = []
    size = w * h
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.array(anchors, np.float32)


# ------------------------------------------------------ box transforms
def bbox_transform(ex_rois, gt_rois):
    """Regression targets (dx, dy, dw, dh) from ``ex_rois`` to
    ``gt_rois``."""
    ew = ex_rois[:, 2] - ex_rois[:, 0] + 1.0
    eh = ex_rois[:, 3] - ex_rois[:, 1] + 1.0
    ecx = ex_rois[:, 0] + 0.5 * (ew - 1)
    ecy = ex_rois[:, 1] + 0.5 * (eh - 1)
    gw = gt_rois[:, 2] - gt_rois[:, 0] + 1.0
    gh = gt_rois[:, 3] - gt_rois[:, 1] + 1.0
    gcx = gt_rois[:, 0] + 0.5 * (gw - 1)
    gcy = gt_rois[:, 1] + 0.5 * (gh - 1)
    return np.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                     np.log(gw / ew), np.log(gh / eh)], axis=1)


def bbox_pred(boxes, deltas):
    """Apply (dx, dy, dw, dh) deltas (4 a class) to ``boxes``."""
    if boxes.shape[0] == 0:
        return np.zeros((0, deltas.shape[1]), deltas.dtype)
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * (w - 1)
    cy = boxes[:, 1] + 0.5 * (h - 1)
    pred = np.zeros_like(deltas)
    for k in range(deltas.shape[1] // 4):
        dx, dy, dw, dh = (deltas[:, 4 * k + i] for i in range(4))
        pcx, pcy = dx * w + cx, dy * h + cy
        pw, ph = np.exp(dw) * w, np.exp(dh) * h
        pred[:, 4 * k] = pcx - 0.5 * (pw - 1)
        pred[:, 4 * k + 1] = pcy - 0.5 * (ph - 1)
        pred[:, 4 * k + 2] = pcx + 0.5 * (pw - 1)
        pred[:, 4 * k + 3] = pcy + 0.5 * (ph - 1)
    return pred


def clip_boxes(boxes, im_shape):
    """Clip (x1, y1, x2, y2[, ...]) to the image (h, w)."""
    boxes = boxes.copy()
    for k, lim in ((0, im_shape[1]), (1, im_shape[0]), (2, im_shape[1]),
                   (3, im_shape[0])):
        boxes[:, k::4] = np.clip(boxes[:, k::4], 0, lim - 1)
    return boxes


def iou_matrix(a, b):
    """(len(a), len(b)) IoU with the +1 pixel convention."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = (np.minimum(a[:, None, 2], b[None, :, 2]) -
          np.maximum(a[:, None, 0], b[None, :, 0]) + 1).clip(0)
    ih = (np.minimum(a[:, None, 3], b[None, :, 3]) -
          np.maximum(a[:, None, 1], b[None, :, 1]) + 1).clip(0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def nms(dets, thresh):
    """Greedy NMS on (x1, y1, x2, y2, score) rows; the kept indices."""
    if len(dets) == 0:
        return []
    order = dets[:, 4].argsort()[::-1]
    iou = iou_matrix(dets[:, :4], dets[:, :4])
    keep = []
    suppressed = np.zeros(len(dets), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > thresh
    return keep


# ------------------------------------------------- RPN anchor targets
def assign_anchor(feat_shape, gt_boxes, im_info, feat_stride,
                  scales, ratios, allowed_border=0, rpn_batch_size=64,
                  fg_fraction=0.5, pos_thresh=0.7, neg_thresh=0.3,
                  rng=None):
    """RPN targets of one image: label 1 (IoU >= ``pos_thresh``, or a
    gt's best anchor), 0 (below ``neg_thresh``) or -1 (ignored),
    subsampled to ``rpn_batch_size``; regression targets toward the best
    gt.  Returns label (A*H*W,), bbox_target and bbox_weight (A*H*W, 4)
    in the index order h*(W*A) + w*A + a."""
    rng = rng or np.random
    height, width = feat_shape
    base = generate_anchors(feat_stride, ratios, scales)
    sx = np.arange(width) * feat_stride
    sy = np.arange(height) * feat_stride
    shift = np.stack(np.broadcast_arrays(
        sx[None, :, None], sy[:, None, None],
        sx[None, :, None], sy[:, None, None]), axis=-1).astype(np.float32)
    anchors = (base[None, None] + shift).reshape(-1, 4)
    total = len(anchors)
    inside = ((anchors[:, 0] >= -allowed_border) &
              (anchors[:, 1] >= -allowed_border) &
              (anchors[:, 2] < im_info[1] + allowed_border) &
              (anchors[:, 3] < im_info[0] + allowed_border))
    label = np.full(total, -1, np.float32)
    bbox_target = np.zeros((total, 4), np.float32)
    bbox_weight = np.zeros((total, 4), np.float32)
    valid_gt = gt_boxes[gt_boxes[:, 4] >= 0][:, :4] if len(gt_boxes) \
        else np.zeros((0, 4), np.float32)
    if len(valid_gt):
        iou = iou_matrix(anchors, valid_gt)
        best_gt = iou.argmax(1)
        best_iou = iou.max(1)
        label[inside & (best_iou < neg_thresh)] = 0
        label[iou.argmax(0)] = 1
        label[inside & (best_iou >= pos_thresh)] = 1
        label[~inside] = -1
        fg_idx = np.where(label == 1)[0]
        bbox_target[fg_idx] = bbox_transform(anchors[fg_idx],
                                             valid_gt[best_gt[fg_idx]])
        bbox_weight[fg_idx] = 1.0
    else:
        label[inside] = 0
    fg = np.where(label == 1)[0]
    max_fg = int(fg_fraction * rpn_batch_size)
    if len(fg) > max_fg:
        label[rng.choice(fg, len(fg) - max_fg, replace=False)] = -1
    bg = np.where(label == 0)[0]
    max_bg = rpn_batch_size - min(len(fg), max_fg)
    if len(bg) > max_bg:
        label[rng.choice(bg, len(bg) - max_bg, replace=False)] = -1
    bbox_weight[label != 1] = 0.0
    return label, bbox_target, bbox_weight


# --------------------------------------------- proposal-target sampler
class ProposalTarget(_operator.CustomOp):
    """Samples rois into a fixed Fast R-CNN batch with class labels and
    per-class regression targets (from ``RandomState(0)``, anew at every
    call, as the op is created at every call)."""

    def __init__(self, num_classes, batch_rois, fg_fraction, fg_thresh,
                 bg_thresh_hi):
        super().__init__()
        self.num_classes = num_classes
        self.batch_rois = batch_rois
        self.fg_fraction = fg_fraction
        self.fg_thresh = fg_thresh
        self.bg_thresh_hi = bg_thresh_hi
        self.rng = np.random.RandomState(0)

    def forward(self, is_train, req, in_data, out_data, aux):
        rois = in_data[0].asnumpy()          # (N, 5) batch_idx, x1..y2
        gt = in_data[1].asnumpy()            # (G, 5) x1..y2, cls (pad < 0)
        gt = gt[gt[:, 4] >= 0]
        R = self.batch_rois
        all_boxes = rois[:, 1:5]
        if len(gt):
            # the gt boxes are candidate rois too
            all_boxes = np.vstack([all_boxes, gt[:, :4]])
            iou = iou_matrix(all_boxes, gt[:, :4])
            best = iou.argmax(1)
            best_iou = iou.max(1)
            cls = gt[best, 4] + 1            # 0 is the background
        else:
            best_iou = np.zeros(len(all_boxes), np.float32)
            best = np.zeros(len(all_boxes), np.int64)
            cls = np.zeros(len(all_boxes), np.float32)
        fg = np.where(best_iou >= self.fg_thresh)[0]
        bg = np.where(best_iou < min(self.bg_thresh_hi, self.fg_thresh))[0]
        n_fg = min(len(fg), int(self.fg_fraction * R))
        if len(fg) > n_fg:
            fg = self.rng.choice(fg, n_fg, replace=False)
        n_bg = R - n_fg
        if len(bg) > n_bg:
            bg = self.rng.choice(bg, n_bg, replace=False)
        elif len(bg) > 0:
            bg = self.rng.choice(bg, n_bg, replace=True)
        else:
            bg = np.zeros(n_bg, np.int64)
        keep = np.concatenate([fg, bg]).astype(np.int64)
        out_rois = np.zeros((R, 5), np.float32)
        out_rois[:, 1:5] = all_boxes[keep]
        label = cls[keep].copy()
        label[n_fg:] = 0
        target = np.zeros((R, 4 * self.num_classes), np.float32)
        weight = np.zeros((R, 4 * self.num_classes), np.float32)
        if len(gt) and n_fg > 0:
            t = bbox_transform(all_boxes[keep[:n_fg]],
                               gt[best[keep[:n_fg]], :4])
            for i in range(n_fg):
                c = int(label[i])
                target[i, 4 * c:4 * c + 4] = t[i]
                weight[i, 4 * c:4 * c + 4] = 1.0
        self.assign(out_data[0], req[0], out_rois)
        self.assign(out_data[1], req[1], label)
        self.assign(out_data[2], req[2], target)
        self.assign(out_data[3], req[3], weight)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        for i in range(len(in_grad)):
            self.assign(in_grad[i], req[i],
                        np.zeros(in_grad[i].shape, np.float32))


@_operator.register("proposal_target")
class ProposalTargetProp(_operator.CustomOpProp):
    def __init__(self, num_classes, batch_rois=32, fg_fraction=0.5,
                 fg_thresh=0.5, bg_thresh_hi=0.5):
        super().__init__(need_top_grad=False)
        self.num_classes = int(num_classes)
        self.batch_rois = int(batch_rois)
        self.fg_fraction = float(fg_fraction)
        self.fg_thresh = float(fg_thresh)
        self.bg_thresh_hi = float(bg_thresh_hi)

    def list_arguments(self):
        return ["rois", "gt_boxes"]

    def list_outputs(self):
        return ["rois_output", "label", "bbox_target", "bbox_weight"]

    def infer_shape(self, in_shape):
        R = self.batch_rois
        return (in_shape,
                [(R, 5), (R,), (R, 4 * self.num_classes),
                 (R, 4 * self.num_classes)], [])

    def create_operator(self, ctx, shapes, dtypes):
        return ProposalTarget(self.num_classes, self.batch_rois,
                              self.fg_fraction, self.fg_thresh,
                              self.bg_thresh_hi)


# ---------------------------------------------------------------- symbols
FEAT_STRIDE = 8
ANCHOR_SCALES = (2, 4)
ANCHOR_RATIOS = (1.0,)
NUM_ANCHORS = len(ANCHOR_SCALES) * len(ANCHOR_RATIOS)


def get_trunk(data):
    """Three stride-2 convolutions: feature stride 8."""
    import mxnet_tpu_torch as mx
    x = data
    for i, nf in enumerate((16, 32, 64)):
        x = mx.sym.Convolution(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                               num_filter=nf, name="conv%d" % (i + 1))
        x = mx.sym.Activation(x, act_type="relu", name="relu%d" % (i + 1))
    return x


def rpn_heads(feat, num_anchors):
    import mxnet_tpu_torch as mx
    rpn_conv = mx.sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                                  num_filter=64, name="rpn_conv_3x3")
    rpn_relu = mx.sym.Activation(rpn_conv, act_type="relu")
    cls = mx.sym.Convolution(rpn_relu, kernel=(1, 1),
                             num_filter=2 * num_anchors,
                             name="rpn_cls_score")
    bbox = mx.sym.Convolution(rpn_relu, kernel=(1, 1),
                              num_filter=4 * num_anchors,
                              name="rpn_bbox_pred")
    return cls, bbox


def rcnn_heads(feat, rois, num_classes, pooled=(4, 4)):
    import mxnet_tpu_torch as mx
    pool = mx.sym.ROIPooling(data=feat, rois=rois, pooled_size=pooled,
                             spatial_scale=1.0 / FEAT_STRIDE,
                             name="roi_pool")
    fc6 = mx.sym.FullyConnected(mx.sym.Flatten(pool), num_hidden=128,
                                name="fc6")
    relu6 = mx.sym.Activation(fc6, act_type="relu")
    cls_score = mx.sym.FullyConnected(relu6, num_hidden=num_classes,
                                      name="cls_score")
    bbox_pred = mx.sym.FullyConnected(relu6, num_hidden=4 * num_classes,
                                      name="bbox_pred")
    return cls_score, bbox_pred


def _proposal(mx, rpn_cls, rpn_bbox, im_info, rpn_pre_nms, rpn_post_nms):
    """(1, 2A, H, W) scores -> per-anchor softmax -> Proposal."""
    rpn_cls_reshape = mx.sym.Reshape(rpn_cls, shape=(0, -4, 2, -1, -2),
                                     name="rpn_cls_reshape")
    rpn_cls_act = mx.sym.SoftmaxActivation(rpn_cls_reshape, mode="channel",
                                           name="rpn_cls_act")
    rpn_cls_act = mx.sym.Reshape(rpn_cls_act, shape=(0, -3, -2),
                                 name="rpn_cls_act_reshape")
    return rpn_cls_reshape, mx.sym.Proposal(
        cls_prob=rpn_cls_act, bbox_pred=rpn_bbox, im_info=im_info,
        name="rois", feature_stride=FEAT_STRIDE, scales=ANCHOR_SCALES,
        ratios=ANCHOR_RATIOS, rpn_pre_nms_top_n=rpn_pre_nms,
        rpn_post_nms_top_n=rpn_post_nms, threshold=0.7, rpn_min_size=4)


def get_rcnn_train(num_classes=3, num_anchors=NUM_ANCHORS,
                   rpn_batch_size=64, batch_rois=32,
                   rpn_pre_nms=400, rpn_post_nms=64):
    """The training symbol: RPN losses, Proposal, proposal_target,
    ROIPooling and the Fast R-CNN losses; outputs (rpn_cls_prob,
    rpn_bbox_loss, cls_prob, bbox_loss, the sampled labels)."""
    import mxnet_tpu_torch as mx
    data = mx.sym.Variable("data")
    im_info = mx.sym.Variable("im_info")
    gt_boxes = mx.sym.Variable("gt_boxes")
    rpn_label = mx.sym.Variable("label")
    rpn_bbox_target = mx.sym.Variable("bbox_target")
    rpn_bbox_weight = mx.sym.Variable("bbox_weight")
    feat = get_trunk(data)
    rpn_cls, rpn_bbox = rpn_heads(feat, num_anchors)
    rpn_cls_reshape, rois = _proposal(mx, rpn_cls, rpn_bbox, im_info,
                                      rpn_pre_nms, rpn_post_nms)
    rpn_cls_prob = mx.sym.SoftmaxOutput(
        data=rpn_cls_reshape, label=rpn_label, multi_output=True,
        normalization="valid", use_ignore=True, ignore_label=-1,
        name="rpn_cls_prob")
    rpn_bbox_loss_ = rpn_bbox_weight * mx.sym.smooth_l1(
        data=rpn_bbox - rpn_bbox_target, scalar=3.0, name="rpn_bbox_loss_")
    rpn_bbox_loss = mx.sym.MakeLoss(rpn_bbox_loss_,
                                    grad_scale=1.0 / rpn_batch_size,
                                    name="rpn_bbox_loss")
    gt_reshape = mx.sym.Reshape(gt_boxes, shape=(-1, 5),
                                name="gt_boxes_reshape")
    group = mx.sym.Custom(rois=rois, gt_boxes=gt_reshape,
                          op_type="proposal_target", num_classes=num_classes,
                          batch_rois=batch_rois, name="ptarget")
    rois, label, bbox_target, bbox_weight = (group[i] for i in range(4))
    cls_score, bbox_pred = rcnn_heads(feat, rois, num_classes)
    cls_prob = mx.sym.SoftmaxOutput(data=cls_score, label=label,
                                    normalization="batch", name="cls_prob")
    bbox_loss_ = bbox_weight * mx.sym.smooth_l1(
        data=bbox_pred - bbox_target, scalar=1.0, name="bbox_loss_")
    bbox_loss = mx.sym.MakeLoss(bbox_loss_, grad_scale=1.0 / batch_rois,
                                name="bbox_loss")
    return mx.sym.Group([rpn_cls_prob, rpn_bbox_loss, cls_prob, bbox_loss,
                         mx.sym.BlockGrad(label)])


def get_rcnn_test(num_classes=3, num_anchors=NUM_ANCHORS,
                  rpn_pre_nms=400, rpn_post_nms=32):
    """The test symbol: outputs (rois, cls_prob, bbox_pred)."""
    import mxnet_tpu_torch as mx
    data = mx.sym.Variable("data")
    im_info = mx.sym.Variable("im_info")
    feat = get_trunk(data)
    rpn_cls, rpn_bbox = rpn_heads(feat, num_anchors)
    _reshape, rois = _proposal(mx, rpn_cls, rpn_bbox, im_info, rpn_pre_nms,
                               rpn_post_nms)
    cls_score, bbox_pred = rcnn_heads(feat, rois, num_classes)
    cls_prob = mx.sym.SoftmaxActivation(cls_score, name="cls_prob")
    return mx.sym.Group([rois, cls_prob, bbox_pred])


# ----------------------------------------------------------- train, test
IM_SIZE = 96
NUM_CLASSES = 3        # background and 2 classes
MAX_GT = 4


def synthetic_detection(n, size=IM_SIZE, seed=0):
    """Images (n, 1, size, size) and gt arrays (n, MAX_GT, 5) [x1, y1, x2,
    y2, cls - 1], padded with -1."""
    rng = np.random.RandomState(seed)
    images = np.zeros((n, 1, size, size), "f")
    gts = -np.ones((n, MAX_GT, 5), "f")
    for i in range(n):
        for j in range(rng.randint(1, 3)):
            cls = rng.randint(0, NUM_CLASSES - 1)
            w, h = rng.randint(20, 44, 2)
            x1 = rng.randint(0, size - w)
            y1 = rng.randint(0, size - h)
            images[i, 0, y1:y1 + h, x1:x1 + w] = 0.4 + 0.5 * cls
            gts[i, j] = [x1, y1, x1 + w - 1, y1 + h - 1, cls]
        images[i, 0] += 0.05 * rng.randn(size, size)
    return images.astype("f"), gts


class AnchorLoader(_DataIter):
    """One image a batch with its RPN anchor targets (host arrays)."""

    def __init__(self, images, gts, shuffle=False, seed=0):
        super().__init__()
        self.images, self.gts = images, gts
        self.batch_size = 1
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.hf = IM_SIZE // FEAT_STRIDE
        self.wf = IM_SIZE // FEAT_STRIDE
        from mxnet_tpu_torch.io import DataDesc
        A = NUM_ANCHORS
        self.provide_data = [
            DataDesc("data", (1, 1, IM_SIZE, IM_SIZE)),
            DataDesc("im_info", (1, 3)),
            DataDesc("gt_boxes", (1, MAX_GT, 5))]
        self.provide_label = [
            DataDesc("label", (1, A, self.hf, self.wf)),
            DataDesc("bbox_target", (1, 4 * A, self.hf, self.wf)),
            DataDesc("bbox_weight", (1, 4 * A, self.hf, self.wf))]
        self.reset()

    def reset(self):
        self.order = (self.rng.permutation(len(self.images))
                      if self.shuffle else np.arange(len(self.images)))
        self.cur = 0

    def next(self):
        import mxnet_tpu_torch as mx
        if self.cur >= len(self.order):
            raise StopIteration
        i = self.order[self.cur]
        self.cur += 1
        gt = self.gts[i]
        label, t, w = assign_anchor(
            (self.hf, self.wf), gt, (IM_SIZE, IM_SIZE), FEAT_STRIDE,
            ANCHOR_SCALES, ANCHOR_RATIOS, rng=self.rng)
        A = NUM_ANCHORS
        # h, w, a order -> the (A, H, W) and (4A, H, W) channel layouts
        label = label.reshape(self.hf, self.wf, A).transpose(2, 0, 1)
        t = t.reshape(self.hf, self.wf, A, 4).transpose(2, 3, 0, 1) \
            .reshape(4 * A, self.hf, self.wf)
        w = w.reshape(self.hf, self.wf, A, 4).transpose(2, 3, 0, 1) \
            .reshape(4 * A, self.hf, self.wf)
        im_info = np.array([[IM_SIZE, IM_SIZE, 1.0]], "f")
        cpu = mx.cpu()
        return mx.io.DataBatch(
            data=[mx.nd.array(self.images[i][None], ctx=cpu),
                  mx.nd.array(im_info, ctx=cpu),
                  mx.nd.array(gt[None], ctx=cpu)],
            label=[mx.nd.array(label[None], ctx=cpu),
                   mx.nd.array(t[None], ctx=cpu),
                   mx.nd.array(w[None], ctx=cpu)],
            pad=0, index=None, provide_data=self.provide_data,
            provide_label=self.provide_label)


class RPNAccuracy(_EvalMetric):
    """The RPN's foreground/background accuracy over anchors not
    ignored."""

    def __init__(self):
        super().__init__("rpn-acc")

    def update(self, labels, preds):
        pred = preds[0].asnumpy().argmax(1).ravel()
        lab = labels[0].asnumpy().ravel()
        keep = lab != -1
        self.sum_metric += (pred[keep] == lab[keep]).sum()
        self.num_inst += keep.sum()


class RCNNAccuracy(_EvalMetric):
    """The Fast R-CNN head's accuracy on the sampled rois (labels from the
    graph's proposal_target output, ``preds[4]``)."""

    def __init__(self):
        super().__init__("rcnn-acc")

    def update(self, labels, preds):
        pred = preds[2].asnumpy().argmax(1).ravel()
        lab = preds[4].asnumpy().ravel()
        self.sum_metric += (pred == lab).sum()
        self.num_inst += lab.size


class RCNNLosses(_EvalMetric):
    """The four losses a step: the RPN's log loss over anchors not
    ignored and its SmoothL1 sum, the head's log loss and its SmoothL1
    sum; ``steps`` keeps every step's four across resets."""

    NAMES = ["rpn-logloss", "rpn-l1", "rcnn-logloss", "rcnn-l1"]

    def __init__(self, eps=1e-14):
        self.eps = eps
        self.steps = []
        super().__init__("rcnn-losses")

    def reset(self):
        self.num_inst = 0
        self.sum_metric = np.zeros(4)

    def update(self, labels, preds):
        rpn_prob = preds[0].asnumpy()                 # (1, 2, A, H, W)
        lab = labels[0].asnumpy()                     # (1, A, H, W)
        keep = lab != -1
        p = np.take_along_axis(rpn_prob, np.maximum(lab, 0).astype(
            np.int64)[:, None], 1)[:, 0]
        rpn = float(-np.log(p[keep] + self.eps).mean()) if keep.any() \
            else 0.0
        prob = preds[2].asnumpy()
        rl = preds[4].asnumpy().astype(np.int64)
        rcnn = float(-np.log(prob[np.arange(len(rl)), rl] + self.eps).mean())
        step = np.array([rpn, float(preds[1].asnumpy().sum()), rcnn,
                         float(preds[3].asnumpy().sum())])
        self.steps.append(step.tolist())
        self.sum_metric = self.sum_metric + step
        self.num_inst += 1

    def get(self):
        return (self.NAMES, list(self.sum_metric / max(self.num_inst, 1)))


def train(epochs=4, n_train=200, lr=2e-3, ctx=None, seed=0, metrics=(),
          batch_end_callback=None):
    """``train_end2end.py``'s fit: returns the Module.  ``metrics`` are
    added to the example's two accuracies; ``batch_end_callback`` runs
    before the Speedometer."""
    import mxnet_tpu_torch as mx
    ctx = ctx or mx.current_context()
    images, gts = synthetic_detection(n_train, seed=seed)
    it = AnchorLoader(images, gts, shuffle=True, seed=seed + 1)
    net = get_rcnn_train(NUM_CLASSES)
    mod = mx.module.Module(net, context=ctx,
                           data_names=("data", "im_info", "gt_boxes"),
                           label_names=("label", "bbox_target",
                                        "bbox_weight"))
    metric = mx.metric.CompositeEvalMetric(
        metrics=[RPNAccuracy(), RCNNAccuracy(), *metrics])
    callbacks = [batch_end_callback] if batch_end_callback else []
    mod.fit(it, num_epoch=epochs,
            initializer=mx.init.Xavier(),
            optimizer="sgd",
            optimizer_params={"learning_rate": lr, "momentum": 0.9,
                              "wd": 5e-4, "clip_gradient": 5.0},
            eval_metric=metric,
            batch_end_callback=callbacks + [mx.callback.Speedometer(1, 50)])
    return mod


def detect(mod_params, images, nms_thresh=0.3, score_thresh=0.1,
           ctx=None):
    """The test symbol on each image, then per-class box decoding and
    NMS on the host; per image (m, 6) [cls, score, x1, y1, x2, y2]."""
    import mxnet_tpu_torch as mx
    ctx = ctx or mx.current_context()
    mod = mx.module.Module(get_rcnn_test(NUM_CLASSES), context=ctx,
                           data_names=("data", "im_info"), label_names=[])
    mod.bind(data_shapes=[("data", (1, 1, IM_SIZE, IM_SIZE)),
                          ("im_info", (1, 3))], for_training=False)
    mod.set_params(*mod_params)
    im_info = np.array([[IM_SIZE, IM_SIZE, 1.0]], "f")
    results = []
    for img in images:
        mod.forward(mx.io.DataBatch(
            data=[mx.nd.array(img[None], ctx=mx.cpu()),
                  mx.nd.array(im_info, ctx=mx.cpu())]), is_train=False)
        rois, cls_prob, deltas = (o.asnumpy() for o in mod.get_outputs())
        boxes = clip_boxes(bbox_pred(rois[:, 1:5], deltas),
                           (IM_SIZE, IM_SIZE))
        dets = []
        for c in range(1, NUM_CLASSES):
            score = cls_prob[:, c]
            keep = score > score_thresh
            if not keep.any():
                continue
            cdet = np.hstack([boxes[keep, 4 * c:4 * c + 4],
                              score[keep, None]])
            for k in nms(cdet, nms_thresh):
                dets.append([c - 1, cdet[k, 4], *cdet[k, :4]])
        results.append(np.array(dets, "f").reshape(-1, 6))
    return results


def evaluate(mod, n_test=50, seed=99, ctx=None):
    """VOC mAP at IoU 0.5 on ``n_test`` made images (the SSD tool's
    metric)."""
    import mxnet_tpu_torch as mx
    from .ssd import MApMetric
    images, gts = synthetic_detection(n_test, seed=seed)
    dets = detect(mod.get_params(), images, ctx=ctx)
    metric = MApMetric(ovp_thresh=0.5)
    cpu = mx.cpu()
    for img_dets, gt in zip(dets, gts):
        valid = gt[gt[:, 4] >= 0]
        label = -np.ones((1, MAX_GT, 6), "f")
        label[0, :len(valid), 0] = valid[:, 4]
        label[0, :len(valid), 1:5] = valid[:, :4] / IM_SIZE
        pred = img_dets.copy().reshape(1, -1, 6)
        if pred.size:
            pred[0, :, 2:6] = pred[0, :, 2:6] / IM_SIZE
        metric.update([mx.nd.array(label, ctx=cpu)],
                      [mx.nd.array(pred, ctx=cpu)])
    _name, value = metric.get()
    mean_ap = value[-1] if isinstance(value, list) else value
    logging.info("toy VOC mAP@0.5 = %.3f", mean_ap)
    return mean_ap


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="train Faster R-CNN end to end")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--images", type=int, default=200)
    p.add_argument("--test-images", type=int, default=50)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", type=int, default=0,
                   help="1 to train on the CPU (default: gpu(0))")
    return p.parse_args(argv)


def run(a, ctx):
    """:func:`train` then :func:`evaluate` with the arguments ``a`` on
    ``ctx``; the JSON line's fields."""
    import torch
    on_card = ctx.device_type == "gpu"
    if on_card:
        dev = ctx.torch_device()
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    stamps = []

    def stamp(param):
        if on_card:
            torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())

    losses = RCNNLosses()
    calls = _operator.Custom.host_calls
    t0 = time.perf_counter()
    mod = train(epochs=a.epochs, n_train=a.images, lr=a.lr, ctx=ctx,
                seed=a.seed, metrics=[losses], batch_end_callback=stamp)
    fit_s = time.perf_counter() - t0
    steps = len(stamps)
    round_trips = (_operator.Custom.host_calls - calls) / max(steps, 1)
    step_ms = [(t - s) * 1e3 for t, s in zip(stamps[1:], stamps[:-1])]
    t0 = time.perf_counter()
    mean_ap = evaluate(mod, n_test=a.test_images, ctx=ctx)
    eval_s = time.perf_counter() - t0
    per_epoch = steps // a.epochs
    epochs = [dict(zip(RCNNLosses.NAMES, np.mean(
        losses.steps[e * per_epoch:(e + 1) * per_epoch], 0).tolist()))
        for e in range(a.epochs)]
    args, aux = mod.get_params()
    out = {"epochs": a.epochs, "images": a.images,
           "test_images": a.test_images, "steps": steps,
           "params": int(sum(v.size for v in args.values())),
           "epoch_losses": epochs,
           "first_losses": np.mean(losses.steps[:10], 0).tolist(),
           "last_losses": np.mean(losses.steps[-10:], 0).tolist(),
           "median_step_ms": float(np.median(step_ms[10:] or step_ms)),
           "custom_round_trips_per_step": round_trips,
           "mAP": float(mean_ap), "fit_s": fit_s, "eval_s": eval_s,
           "finite": bool(all(np.isfinite(v.asnumpy()).all()
                              for d in (args, aux) for v in d.values())),
           "context": str(ctx)}
    if on_card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    return out, mod


def main(argv=None):
    import torch
    import mxnet_tpu_torch as mx
    from . import nvidia_smi
    a = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if a.cpu:
        ctx = mx.cpu()
    elif not torch.cuda.is_available():
        raise SystemExit("rcnn: no CUDA device; pass --cpu 1 to train on the "
                         "CPU")
    else:
        ctx = mx.gpu(0)
    out, _mod = run(a, ctx)
    if ctx.device_type == "gpu":
        out["device"] = torch.cuda.get_device_name(ctx.device_id)
        out["nvidia_smi"] = nvidia_smi()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
