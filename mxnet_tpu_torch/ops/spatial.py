"""Spatial-warp and detection ops: the counterpart of
``mxnet_tpu/ops/spatial.py`` (the reference's ``grid_generator``,
``bilinear_sampler``, ``spatial_transformer``, ``roi_pooling``,
``correlation`` and ``contrib/proposal``).

* Bilinear sampling gathers the four corners of every sample point; a
  corner outside the image reads 0 (``BilinearSampler``), or the sample
  point is first clamped into the image (``SpatialTransformer``).  The
  gradient reaches the data and the grid.
* ``ROIPooling`` is a separable masked max, along W then along H, with
  ``amax``: a tie splits the gradient evenly, as the JAX op's
  ``jnp.max`` does.  Box corners round half to even (``jnp.round``).
* ``Correlation`` sums shifted products over a box window, one
  displacement at a time.
* ``_contrib_Proposal`` decodes the RPN's anchors, keeps the
  ``rpn_pre_nms_top_n`` best in a stable order, suppresses greedily over
  an IoU matrix computed once (the rule ignores scores: a box scored -1,
  too small or on the padded part of the map, still suppresses unless
  suppressed itself) and pads its output cyclically; like the other
  detection ops it runs on ``meta`` and makes no host sync on the card,
  and it passes no gradient.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .contrib import argsort_descending, device_constant, \
    suppress_greedy
from .registry import register

__all__ = ["generate_anchors", "greedy_nms"]


# ---------------------------------------------------------------- sampling
def _bilinear_sample(data, x_real, y_real, padding="zero"):
    """Bilinear samples of ``data`` (N, C, H, W) at pixel coordinates
    ``x_real``/``y_real`` (N, Ho, Wo) -> (N, C, Ho, Wo)."""
    n, _c, h, w = data.shape
    if padding == "border":
        # min(max(x, 0), w - 1): a point on the border passes half its
        # gradient, as jnp.clip does
        x_real = torch.minimum(torch.maximum(x_real, _full(x_real, 0.0)),
                               _full(x_real, w - 1.0))
        y_real = torch.minimum(torch.maximum(y_real, _full(y_real, 0.0)),
                               _full(y_real, h - 1.0))
    tl_x = torch.floor(x_real)
    tl_y = torch.floor(y_real)
    wx = 1.0 - (x_real - tl_x)
    wy = 1.0 - (y_real - tl_y)
    tl_xi = tl_x.long()
    tl_yi = tl_y.long()
    batch = torch.arange(n, device=data.device)[:, None, None]

    def corner(xi, yi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        v = data[batch, :, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, 0.0)     # (N, Ho, Wo, C)

    out = (corner(tl_xi, tl_yi) * (wy * wx)[..., None]
           + corner(tl_xi + 1, tl_yi) * (wy * (1 - wx))[..., None]
           + corner(tl_xi, tl_yi + 1) * ((1 - wy) * wx)[..., None]
           + corner(tl_xi + 1, tl_yi + 1) * ((1 - wy) * (1 - wx))[..., None])
    return out.permute(0, 3, 1, 2)


def _full(x, v):
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _sample_normalized(data, grid, padding):
    _, _, h, w = data.shape
    x_real = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    y_real = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    return _bilinear_sample(data, x_real, y_real, padding)


def _affine_grid(loc, target_shape):
    """(N, 2, H, W) source coordinates in [-1, 1] from (N, 6) affine
    matrices over the target's normalized grid."""
    th, tw = int(target_shape[0]), int(target_shape[1])
    kw = dict(dtype=loc.dtype, device=loc.device)
    xs = -1.0 + torch.arange(tw, **kw) * (2.0 / (tw - 1)) if tw > 1 \
        else torch.zeros(1, **kw) - 1.0
    ys = -1.0 + torch.arange(th, **kw) * (2.0 / (th - 1)) if th > 1 \
        else torch.zeros(1, **kw) - 1.0
    gx = xs[None, :].expand(th, tw).reshape(-1)
    gy = ys[:, None].expand(th, tw).reshape(-1)
    grid_dst = torch.stack([gx, gy, torch.ones_like(gx)], dim=0)
    theta = loc.reshape(-1, 2, 3)
    return torch.matmul(theta, grid_dst).reshape(-1, 2, th, tw)


@register("GridGenerator", arg_names=("data",),
          params={"transform_type": "affine", "target_shape": (0, 0)})
def grid_generator(attrs, ctx, data):
    """affine: (N, 6) matrices -> (N, 2, H, W) normalized grid; warp:
    (N, 2, H, W) optical flow -> (flow + identity) normalized to
    [-1, 1]."""
    if attrs["transform_type"] == "affine":
        return _affine_grid(data, attrs["target_shape"])
    _n, _two, h, w = data.shape
    kw = dict(dtype=data.dtype, device=data.device)
    gx = torch.arange(w, **kw)[None, :].expand(h, w)
    gy = torch.arange(h, **kw)[:, None].expand(h, w)
    ident = torch.stack([gx, gy], dim=0)
    denom = torch.stack([_full(data, (w - 1.0) / 2.0),
                         _full(data, (h - 1.0) / 2.0)]).reshape(1, 2, 1, 1)
    return (data + ident[None]) / denom - 1.0


@register("BilinearSampler", arg_names=("data", "grid"))
def bilinear_sampler(attrs, ctx, data, grid):
    """``data`` (N, C, H, W) sampled at ``grid`` (N, 2, Ho, Wo), x then y
    in [-1, 1]; samples outside the image read 0."""
    return _sample_normalized(data, grid, padding="zero")


@register("SpatialTransformer", arg_names=("data", "loc"),
          params={"target_shape": (0, 0), "transform_type": "affine",
                  "sampler_type": "bilinear"})
def spatial_transformer(attrs, ctx, data, loc):
    """Affine spatial transformer: the grid of (N, 6) ``loc`` over
    ``target_shape``, sampled with the points clamped into the image."""
    if attrs["transform_type"] != "affine" \
            or attrs["sampler_type"] != "bilinear":
        raise ValueError("SpatialTransformer takes only affine, bilinear")
    grid = _affine_grid(loc, attrs["target_shape"])
    return _sample_normalized(data, grid, padding="border")


# ---------------------------------------------------------------- ROI pool
@register("ROIPooling", arg_names=("data", "rois"),
          params={"pooled_size": (0, 0), "spatial_scale": 1.0})
def roi_pooling(attrs, ctx, data, rois):
    """Max pooling of ``data`` (N, C, H, W) over ``rois`` (R, 5) rows
    [batch_idx, x1, y1, x2, y2] (image coordinates, times
    ``spatial_scale``) into (R, C, ph, pw) bins.  An empty bin gives 0;
    ``rois`` get no gradient."""
    ph, pw = (int(s) for s in attrs["pooled_size"])
    scale = float(attrs["spatial_scale"])
    _n, _c, h, w = data.shape
    rois = rois.detach()
    batch_ind = rois[:, 0].long()
    start_w, start_h, end_w, end_h = (
        torch.round(rois[:, i] * scale).long() for i in (1, 2, 3, 4))
    roi_h = (end_h - start_h + 1).clamp(min=1).to(data.dtype)
    roi_w = (end_w - start_w + 1).clamp(min=1).to(data.dtype)

    def axis_masks(start, bin_size, pooled, size):
        # (R, pooled, size): does pixel k fall in bin p of roi r
        p = torch.arange(pooled, dtype=data.dtype, device=data.device)
        lo = torch.floor(p[None, :] * bin_size[:, None]).long()
        hi = torch.ceil((p[None, :] + 1) * bin_size[:, None]).long()
        lo = (lo + start[:, None]).clamp(0, size)
        hi = (hi + start[:, None]).clamp(0, size)
        k = torch.arange(size, device=data.device)
        return (k >= lo[:, :, None]) & (k < hi[:, :, None])

    mh = axis_masks(start_h, roi_h / ph, ph, h)           # (R, ph, H)
    mw = axis_masks(start_w, roi_w / pw, pw, w)           # (R, pw, W)
    neg = float("-inf")
    per_roi = data.index_select(0, batch_ind)             # (R, C, H, W)
    t = torch.where(mw[:, None, None], per_roi[:, :, :, None, :], neg)
    t = t.amax(dim=-1)                                    # (R, C, H, pw)
    o = torch.where(mh[:, None, :, None, :],
                    t.transpose(2, 3)[:, :, None], neg)
    o = o.amax(dim=-1)                                    # (R, C, ph, pw)
    empty = ~(mh.any(-1)[:, None, :, None] & mw.any(-1)[:, None, None, :])
    return torch.where(empty | torch.isneginf(o), 0.0, o)


# ------------------------------------------------------------- correlation
@register("Correlation", arg_names=("data1", "data2"),
          params={"kernel_size": 1, "max_displacement": 1, "stride1": 1,
                  "stride2": 1, "pad_size": 0, "is_multiply": True})
def correlation(attrs, ctx, data1, data2):
    """FlowNet correlation: for each displacement (one output channel of
    (2 * max_displacement / stride2 + 1)^2) the kernel-window sum of
    data1 times (or minus, in absolute value) displaced data2, over
    kernel_size^2 * channels."""
    k = int(attrs["kernel_size"])
    md = int(attrs["max_displacement"])
    s1 = int(attrs["stride1"])
    s2 = int(attrs["stride2"])
    pad = int(attrs["pad_size"])
    mult = bool(attrs["is_multiply"])
    _n, c, h, w = data1.shape
    hp, wp = h + 2 * pad, w + 2 * pad
    border = md + (k - 1) // 2
    top_w = int(math.ceil(float(wp - border * 2) / s1))
    top_h = int(math.ceil(float(hp - border * 2) / s1))
    ngr = md // s2
    ngw = ngr * 2 + 1
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    box = torch.ones(1, 1, k, k, dtype=data1.dtype, device=data1.device)
    outs = []
    for tc in range(ngw * ngw):
        s2o = (tc % ngw - ngr) * s2
        s2p = (tc // ngw - ngr) * s2
        sh2 = torch.roll(p2, (-s2p, -s2o), dims=(2, 3))
        prod = p1 * sh2 if mult else (p1 - sh2).abs()
        win = F.conv2d(prod.sum(1, keepdim=True), box)[:, 0]
        sl = win[:, md:md + top_h * s1:s1, md:md + top_w * s1:s1]
        outs.append(sl / (k * k * c))
    return torch.stack(outs, dim=1)


# ---------------------------------------------------------------- proposal
def generate_anchors(base_size, ratios, scales):
    """Anchor windows, ratio-major then scale (proposal-inl.h's
    GenerateAnchors), as an (A, 4) float32 numpy array."""
    w = h = float(base_size)
    x_ctr = 0.5 * (w - 1.0)
    y_ctr = 0.5 * (h - 1.0)
    size = w * h
    out = []
    for ratio in ratios:
        size_ratio = math.floor(size / ratio)
        for scale in scales:
            nw = math.floor(math.sqrt(size_ratio) + 0.5) * scale
            nh = math.floor((nw / scale * ratio) + 0.5) * scale
            out.append([x_ctr - 0.5 * (nw - 1.0), y_ctr - 0.5 * (nh - 1.0),
                        x_ctr + 0.5 * (nw - 1.0), y_ctr + 0.5 * (nh - 1.0)])
    return np.array(out, np.float32)


def _pairwise_iou(boxes):
    """(n, n) IoU with the +1 pixel convention of proposal.cc."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    iw = (torch.minimum(x2[:, None], x2[None, :])
          - torch.maximum(x1[:, None], x1[None, :]) + 1.0).clamp(min=0.0)
    ih = (torch.minimum(y2[:, None], y2[None, :])
          - torch.maximum(y1[:, None], y1[None, :]) + 1.0).clamp(min=0.0)
    inter = iw * ih
    return inter / (area[:, None] + area[None, :] - inter)


def greedy_nms(boxes, thresh):
    """Suppressed flags of score-sorted ``boxes`` (n, 4): j is suppressed
    when an earlier box that is not suppressed overlaps it with IoU >
    ``thresh`` (:func:`suppress_greedy` with every box alive at first)."""
    npre = boxes.shape[0]
    ones = torch.ones(npre, npre, dtype=torch.bool, device=boxes.device)
    over = (_pairwise_iou(boxes) > thresh) & ones.triu(1)
    return ~suppress_greedy(ones[:1], over[None])[0]


@register("_contrib_Proposal", arg_names=("cls_prob", "bbox_pred", "im_info"),
          num_outputs=lambda a: 2 if a.get("output_score") else 1,
          params={"rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
                  "threshold": 0.7, "rpn_min_size": 16,
                  "scales": (4.0, 8.0, 16.0, 32.0), "ratios": (0.5, 1.0, 2.0),
                  "feature_stride": 16, "output_score": False,
                  "iou_loss": False},
          aliases=("Proposal",))
def proposal(attrs, ctx, cls_prob, bbox_pred, im_info):
    """RPN region proposals for one image: shifted anchors, deltas applied
    and clipped to the image, small boxes and the padded part of the
    feature map scored -1, the ``rpn_pre_nms_top_n`` best kept,
    :func:`greedy_nms`, then ``rpn_post_nms_top_n`` rois [0, x1, y1, x2,
    y2] (repeated cyclically when fewer survive), and their scores with
    ``output_score``."""
    if cls_prob.shape[0] != 1:
        raise ValueError("Proposal handles one image per call")
    cls_prob, bbox_pred, im_info = (
        t.detach().float() for t in (cls_prob, bbox_pred, im_info))
    dev = cls_prob.device
    num_anchors = cls_prob.shape[1] // 2
    height, width = cls_prob.shape[2], cls_prob.shape[3]
    count = num_anchors * height * width
    stride = int(attrs["feature_stride"])
    pre_nms = int(attrs["rpn_pre_nms_top_n"])
    pre_nms = min(pre_nms, count) if pre_nms > 0 else count
    post_nms = min(int(attrs["rpn_post_nms_top_n"]), pre_nms)

    anchors = device_constant(generate_anchors(
        stride, attrs["ratios"], attrs["scales"]), dev)   # (A, 4)
    sx = torch.arange(width, dtype=torch.float32, device=dev) * stride
    sy = torch.arange(height, dtype=torch.float32, device=dev) * stride
    # box index h*(W*A) + w*A + a
    shape = (height, width, num_anchors)
    shift = torch.stack([sx[None, :, None].expand(shape),
                         sy[:, None, None].expand(shape),
                         sx[None, :, None].expand(shape),
                         sy[:, None, None].expand(shape)], dim=-1)
    boxes = (anchors[None, None] + shift).reshape(count, 4)
    scores = cls_prob[0, num_anchors:].permute(1, 2, 0).reshape(count)
    deltas = bbox_pred[0].reshape(num_anchors, 4, height, width) \
        .permute(2, 3, 0, 1).reshape(count, 4)
    im_h, im_w, im_scale = im_info[0, 0], im_info[0, 1], im_info[0, 2]

    if attrs["iou_loss"]:
        pred = boxes + deltas
    else:
        ws = boxes[:, 2] - boxes[:, 0] + 1.0
        hs = boxes[:, 3] - boxes[:, 1] + 1.0
        ctr_x = boxes[:, 0] + 0.5 * (ws - 1.0)
        ctr_y = boxes[:, 1] + 0.5 * (hs - 1.0)
        pcx = deltas[:, 0] * ws + ctr_x
        pcy = deltas[:, 1] * hs + ctr_y
        pw = torch.exp(deltas[:, 2]) * ws
        phh = torch.exp(deltas[:, 3]) * hs
        pred = torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (phh - 1.0),
                            pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (phh - 1.0)],
                           dim=1)
    lim = torch.stack([im_w, im_h, im_w, im_h]) - 1.0
    pred = torch.minimum(pred.clamp(min=0.0), lim)

    # the padded part of the feature map scores -1
    idx = torch.arange(count, device=dev)
    hh = idx // (width * num_anchors)
    ww = (idx // num_anchors) % width
    real_h = (im_h / stride).long()
    real_w = (im_w / stride).long()
    scores = torch.where((hh >= real_h) | (ww >= real_w), -1.0, scores)

    # boxes below rpn_min_size grow by half of it and score -1
    min_size = attrs["rpn_min_size"] * im_scale
    bw = pred[:, 2] - pred[:, 0] + 1.0
    bh = pred[:, 3] - pred[:, 1] + 1.0
    small = (bw < min_size) | (bh < min_size)
    grow = torch.where(small, min_size / 2.0, 0.0)
    pred = pred + torch.stack([-grow, -grow, grow, grow], dim=1)
    scores = torch.where(small, -1.0, scores)

    order = argsort_descending(scores)[:pre_nms]
    top_boxes = pred[order]
    top_scores = scores[order]
    kept = ~greedy_nms(top_boxes, float(attrs["threshold"]))
    rank = torch.cumsum(kept, 0) - 1
    # the kept indices in order; the rest land on a spare slot, dropped
    keep = torch.zeros(pre_nms + 1, dtype=torch.long, device=dev).scatter_(
        0, torch.where(kept, rank, pre_nms),
        torch.arange(pre_nms, device=dev))[:pre_nms]
    out_size = kept.sum().clamp(max=post_nms).clamp(min=1)
    pick = keep[torch.arange(post_nms, device=dev) % out_size]
    rois = torch.cat([torch.zeros(post_nms, 1, device=dev),
                      top_boxes[pick]], dim=1)
    if attrs.get("output_score"):
        return rois, top_scores[pick][:, None]
    return rois
