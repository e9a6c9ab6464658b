"""The SSD MultiBox ops: the counterpart of ``mxnet_tpu/ops/contrib.py``'s
``_contrib_MultiBoxPrior``, ``_contrib_MultiBoxTarget`` and
``_contrib_MultiBoxDetection`` (the reference's
``src/operator/contrib/multibox_*.cc``).

Every op is a dense, static-shaped program over the batch at once: no
``.item()``, no ``nonzero`` and no boolean-mask indexing, so each runs on
the ``meta`` device (``Symbol.infer_shape``) and makes no host sync on the
card.  None of them passes a gradient to its inputs (the reference's
backward writes zeros; every graph wraps the detection in ``BlockGrad``).

Where the JAX ops leave a choice to the backend, the port writes it down:

* Orders are stable sorts of the negated score, ``-0.0`` taken as ``0.0``
  (``jnp.argsort``'s rule), so tied scores keep index order.
* ``MultiBoxTarget``'s force-match scatters each label row's claim onto
  its best anchor; two rows may name one anchor (a padding row names
  anchor 0).  The JAX op resolves that by the backend's scatter; on the
  CPU the last write wins.  The port states that rule: for each anchor,
  the highest label row that names it decides, padding rows included.
* Greedy NMS walks the score order one box at a time over an IoU matrix
  computed once, the whole batch in each step.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register

__all__ = ["iou", "argsort_descending", "device_constant", "last_claim",
           "suppress_greedy"]


def _tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


def argsort_descending(x, dim=-1):
    """Indices of ``x`` by descending value along ``dim``, ties in index
    order and ``-0.0`` equal to ``0.0``: ``jnp.argsort(-x)``'s order
    (``0.0 - x`` maps both zeros to ``+0.0``)."""
    return torch.argsort(0.0 - x, dim=dim, stable=True)


def iou(a, b):
    """Pairwise IoU of corner boxes ``a`` (..., A, 4) and ``b`` (..., B, 4)
    -> (..., A, B), in the JAX op's order of operations."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])).clamp(
        min=0.0)
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])).clamp(
        min=0.0)
    return inter / (area_a[..., :, None] + area_b[..., None, :]
                    - inter).clamp(min=1e-12)


def device_constant(values, device, dtype=torch.float32):
    """A small table made on the host, on ``device``: on the card through
    pinned memory without blocking, so that the stream is not drained
    (a pageable copy waits for it)."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@register("_contrib_MultiBoxPrior",
          params={"sizes": (1.0,), "ratios": (1.0,), "clip": False,
                  "steps": (-1.0, -1.0), "offsets": (0.5, 0.5)},
          aliases=("MultiBoxPrior",))
def multibox_prior(attrs, ctx, data):
    """Anchor boxes of a (N, C, H, W) feature map: (1, H*W*A, 4) corners in
    [0, 1] coordinates, the anchors (size_i, ratio_0) for every size then
    (size_0, ratio_j) for the other ratios, at each cell centre."""
    h, w = int(data.shape[2]), int(data.shape[3])
    dev = data.device
    sizes = _tuple(attrs["sizes"])
    ratios = _tuple(attrs["ratios"])
    steps, offs = attrs["steps"], attrs["offsets"]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offs[0]) * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offs[1]) * step_x
    # widths and heights in f32, as the JAX op computes them
    f32 = np.float32
    r0 = np.sqrt(f32(ratios[0]))
    whs = [(f32(s) * r0, f32(s) / r0) for s in sizes]
    whs += [(f32(sizes[0]) * np.sqrt(f32(r)), f32(sizes[0]) / np.sqrt(f32(r)))
            for r in ratios[1:]]
    half = device_constant(whs, dev) / 2.0
    CY, CX = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([CX.reshape(-1), CY.reshape(-1)], dim=-1)
    boxes = torch.cat([centers[:, None, :] - half[None],
                       centers[:, None, :] + half[None]], dim=-1)
    boxes = boxes.reshape(-1, 4)
    if attrs["clip"]:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes[None]


def _anchor_frame(anchors):
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    return aw, ah, acx, acy


def last_claim(best_anchor, num_anchors):
    """For each anchor, the highest row ``m`` whose ``best_anchor[..., m]``
    names it, else -1: (..., M) -> (..., A).  The force-match's rule for
    two label rows that claim one anchor, written without a scatter."""
    m = best_anchor.shape[-1]
    rows = torch.arange(m, device=best_anchor.device)
    hit = best_anchor[..., :, None] == torch.arange(
        num_anchors, device=best_anchor.device)
    return torch.where(hit, rows[:, None], -1).amax(dim=-2)


@register("_contrib_MultiBoxTarget",
          arg_names=("anchor", "label", "cls_pred"),
          num_outputs=3,
          params={"overlap_threshold": 0.5, "ignore_label": -1.0,
                  "negative_mining_ratio": -1.0,
                  "negative_mining_thresh": 0.5,
                  "minimum_negative_samples": 0,
                  "variances": (0.1, 0.1, 0.2, 0.2)},
          aliases=("MultiBoxTarget",))
def multibox_target(attrs, ctx, anchor, label, cls_pred):
    """Anchor matching and target encoding.  ``anchor`` (1, A, 4),
    ``label`` (N, M, >= 5) rows [id, xmin, ymin, xmax, ymax, ...] with id
    < 0 for padding, ``cls_pred`` (N, C, A).  Returns ``loc_target`` (N,
    A*4), ``loc_mask`` (N, A*4) and ``cls_target`` (N, A): an anchor is
    positive when a valid row force-matched it (the row's best anchor, by
    :func:`last_claim`) or its best IoU reaches ``overlap_threshold``;
    with ``negative_mining_ratio`` > 0 the ratio * positives negatives of
    highest foreground confidence (best IoU below
    ``negative_mining_thresh``) are class 0 and the other negatives
    ``ignore_label``."""
    var = [float(v) for v in attrs["variances"]]
    thresh = float(attrs["overlap_threshold"])
    anchors = anchor.detach().reshape(-1, 4).float()
    lab = label.detach().float()
    pred = cls_pred.detach().float()
    n_anchors = anchors.shape[0]
    ids = lab[..., 0]                                      # (N, M)
    valid = ids >= 0
    gt = lab[..., 1:5]                                     # (N, M, 4)
    ov = iou(anchors, gt)                                  # (N, A, M)
    ov = torch.where(valid[:, None, :], ov, -1.0)
    best_iou = ov.amax(dim=2)
    best_gt = ov.argmax(dim=2)                             # first maximum
    best_anchor = ov.argmax(dim=1)                         # (N, M)
    claim = last_claim(best_anchor, n_anchors)             # (N, A)
    row = claim.clamp(min=0)
    forced = (claim >= 0) & valid.gather(1, row)
    pos = forced | (best_iou >= thresh)
    match = torch.where(forced, row, best_gt)
    g = gt.gather(1, match[..., None].expand(-1, -1, 4))   # (N, A, 4)
    aw, ah, acx, acy = _anchor_frame(anchors)
    gw = (g[..., 2] - g[..., 0]).clamp(min=1e-8)
    gh = (g[..., 3] - g[..., 1]).clamp(min=1e-8)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    loc = torch.stack([(gcx - acx) / (aw * var[0]),
                       (gcy - acy) / (ah * var[1]),
                       torch.log(gw / aw) / var[2],
                       torch.log(gh / ah) / var[3]], dim=-1)
    loc = torch.where(pos[..., None], loc, 0.0)
    mask = pos[..., None].to(torch.float32).expand_as(loc)
    cls_pos = ids.gather(1, match) + 1.0
    ratio = float(attrs["negative_mining_ratio"])
    if ratio > 0:
        ignore = float(attrs["ignore_label"])
        neg_thr = float(attrs["negative_mining_thresh"])
        min_neg = float(attrs["minimum_negative_samples"])
        fg = torch.softmax(pred, dim=1)[:, 1:].amax(dim=1)  # (N, A)
        eligible = ~pos & (best_iou < neg_thr)
        score = torch.where(eligible, fg, float("-inf"))
        order = argsort_descending(score)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n_anchors, device=order.device)
            .expand_as(order))
        num_neg = torch.minimum(
            (ratio * pos.sum(1, keepdim=True).float()).clamp(min=min_neg),
            eligible.sum(1, keepdim=True).float())
        neg = eligible & (rank.float() < num_neg)
        cls_t = torch.where(pos, cls_pos, torch.where(neg, 0.0, ignore))
    else:
        cls_t = torch.where(pos, cls_pos, 0.0)
    n = lab.shape[0]
    return (loc.reshape(n, -1), mask.reshape(n, -1).contiguous(),
            cls_t)


def suppress_greedy(alive, sup):
    """Greedy NMS over score-sorted rows: for i in order, a row still
    alive at i kills every j with ``sup[..., i, j]``.  ``alive`` (B, K)
    bool, ``sup`` (B, K, K) bool with only j > i set.  One step per row,
    the whole batch in each (two launches a step on the card).
    MultiBoxDetection starts from the rows above its threshold and gates
    ``sup`` by class; Proposal starts from every row, ungated."""
    keep_rows = ~sup
    alive = alive.clone()
    for i in range(sup.shape[-1]):
        alive &= torch.where(alive[:, i:i + 1], keep_rows[:, i], True)
    return alive


@register("_contrib_MultiBoxDetection",
          arg_names=("cls_prob", "loc_pred", "anchor"),
          params={"clip": True, "threshold": 0.01, "background_id": 0,
                  "nms_threshold": 0.5, "force_suppress": False,
                  "variances": (0.1, 0.1, 0.2, 0.2), "nms_topk": -1},
          aliases=("MultiBoxDetection",))
def multibox_detection(attrs, ctx, cls_prob, loc_pred, anchor):
    """Decode and class-wise greedy NMS.  ``cls_prob`` (N, C, A),
    ``loc_pred`` (N, A*4), ``anchor`` (1, A, 4).  Returns (N, A, 6) rows
    [class_id, score, xmin, ymin, xmax, ymax] in descending score order;
    a row suppressed, below ``threshold``, of the background or past
    ``nms_topk`` has class_id -1.  Class ids exclude the background
    (shifted down by one when ``background_id`` is 0)."""
    var = [float(v) for v in attrs["variances"]]
    anchors = anchor.detach().reshape(-1, 4).float()
    probs = cls_prob.detach().float()
    n, _c, n_anchors = probs.shape
    loc = loc_pred.detach().float().reshape(n, -1, 4)
    aw, ah, acx, acy = _anchor_frame(anchors)
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    w = torch.exp(loc[..., 2] * var[2]) * aw
    h = torch.exp(loc[..., 3] * var[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if attrs["clip"]:
        boxes = boxes.clamp(0.0, 1.0)
    bg = int(attrs["background_id"])
    cls = probs.argmax(dim=1)                              # (N, A)
    score = torch.where(cls == bg, 0.0, probs.amax(dim=1))
    keep = score > float(attrs["threshold"])
    order = argsort_descending(score)
    topk = int(attrs["nms_topk"])
    k = min(topk, n_anchors) if topk > 0 else n_anchors
    order_k = order[:, :k]
    boxes_o = boxes.gather(1, order_k[..., None].expand(-1, -1, 4))
    cls_o = cls.gather(1, order_k)
    score_o = score.gather(1, order_k)
    same = cls_o[:, :, None] == cls_o[:, None, :]
    if attrs["force_suppress"]:
        same = torch.ones_like(same)
    later = torch.ones(k, k, dtype=torch.bool, device=probs.device).triu(1)
    sup = (iou(boxes_o, boxes_o) > float(attrs["nms_threshold"])) \
        & same & later
    alive = suppress_greedy(keep.gather(1, order_k), sup)
    shift = 1.0 if bg == 0 else 0.0
    out_cls = torch.where(alive, cls_o.float() - shift, -1.0)
    out = torch.cat([out_cls[..., None], score_o[..., None], boxes_o], -1)
    if k < n_anchors:
        rest = order[:, k:]
        pad = torch.cat([
            torch.full((n, n_anchors - k, 1), -1.0, device=probs.device),
            score.gather(1, rest)[..., None],
            boxes.gather(1, rest[..., None].expand(-1, -1, 4))], dim=-1)
        out = torch.cat([out, pad], dim=1)
    return out
