"""The port's MultiBox ops (``mxnet_tpu_torch/ops/contrib.py``) against the
JAX package's on the CPU, on the same numpy inputs: ``MultiBoxPrior``'s
anchors, ``MultiBoxTarget``'s targets with padded labels, negative mining
and the force-match's rule for two label rows that name one anchor, and
``MultiBoxDetection``'s decode and greedy NMS (``nms_topk`` below the
anchor count, scores tied at 0, ``force_suppress``).  Integer-valued
outputs (class targets, masks, class ids) must be equal; boxes and
scores agree within ``TOL``.  Every op also runs on the ``meta`` device
and passes no gradient."""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import OpContext as JaxOpContext, \
    get_op as jax_get_op

from mxnet_tpu_torch.ops.contrib import last_claim
from mxnet_tpu_torch.ops.registry import OpContext, get_op

from torch_corpus_oracle import cases_of, check_case

#: largest absolute difference of a float output (boxes and offsets in
#: [0, 1] units, log ratios): f32 rounding of the same operations reads
#: 0 on these inputs; 1e-6 leaves room for a reordered sum
TOL = 1e-6


def _both(name, attrs, *inputs):
    jop = jax_get_op(name)
    jattrs = jop.parse_attrs(attrs)
    # one jit a call: one compile, not one a primitive
    want = jax.jit(lambda *xs: jop.fcompute(jattrs, JaxOpContext(), *xs))(
        *inputs)
    op = get_op(name)
    got = op.fcompute(op.parse_attrs({k: str(v) for k, v in attrs.items()}),
                      OpContext(), *[torch.from_numpy(x) for x in inputs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _anchors(rng, n=60):
    c = rng.uniform(0.1, 0.9, (n, 2))
    wh = rng.uniform(0.05, 0.4, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1)[None].astype("f")


def _labels(rng, batch, rows, objects):
    lab = np.full((batch, rows, 6), -1.0, np.float32)
    for b in range(batch):
        for m in range(objects[b]):
            c = rng.uniform(0.2, 0.8, 2)
            wh = rng.uniform(0.1, 0.5, 2)
            lab[b, m] = [rng.randint(0, 4), *(c - wh / 2), *(c + wh / 2), 0]
    return lab


@pytest.mark.parametrize("attrs", [
    {"sizes": (0.1, 0.141), "ratios": (1, 2, 0.5)},
    {"sizes": (0.2, 0.272), "ratios": (1, 2, 0.5, 3, 1.0 / 3)},
    {"sizes": (0.88, 0.961), "ratios": (1, 2, 0.5), "clip": True},
    {"sizes": (0.3,), "ratios": (2.0,), "steps": (0.1, 0.125),
     "offsets": (0.25, 0.75)}], ids=["s0", "s1", "clip", "steps"])
def test_prior_matches_jax(attrs):
    data = np.zeros((2, 3, 5, 7), np.float32)
    (got,), (want,) = _both("_contrib_MultiBoxPrior", attrs, data)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


TARGET = {"overlap_threshold": 0.5, "ignore_label": -1,
          "negative_mining_ratio": 3, "minimum_negative_samples": 0,
          "negative_mining_thresh": 0.5, "variances": (0.1, 0.1, 0.2, 0.2)}


def _check_target(attrs, anchor, label, pred):
    got, want = _both("_contrib_MultiBoxTarget", attrs, anchor, label, pred)
    np.testing.assert_array_equal(got[1], want[1])      # the mask
    np.testing.assert_array_equal(got[2], want[2])      # the class target
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)
    return got


@pytest.mark.parametrize("mining", [True, False])
def test_target_matches_jax_with_padded_labels(mining):
    rng = np.random.RandomState(0)
    anchor = _anchors(rng)
    label = _labels(rng, 4, 5, [1, 3, 5, 0])
    pred = rng.normal(0, 1, (4, 5, 60)).astype("f")
    attrs = dict(TARGET) if mining else {"overlap_threshold": 0.5}
    got = _check_target(attrs, anchor, label, pred)
    cls_t = got[2]
    assert (cls_t[:3] > 0).any(1).all() and not (cls_t[3] > 0).any()
    if mining:
        npos = (cls_t > 0).sum(1)
        assert ((cls_t == 0).sum(1)[:3] <= 3 * npos[:3]).all()
        assert (cls_t == -1).any()


def test_target_negative_mining_ties_keep_index_order():
    """Equal foreground confidences (cls_pred the same for every anchor)
    leave the choice of negatives to the sort's tie rule: the lowest
    indices first, as jnp.argsort's stable order takes them."""
    rng = np.random.RandomState(1)
    anchor = _anchors(rng, 40)
    label = _labels(rng, 2, 3, [2, 1])
    pred = np.zeros((2, 4, 40), np.float32)
    got = _check_target(dict(TARGET, negative_mining_ratio=2), anchor,
                        label, pred)
    for b in range(2):
        neg = np.flatnonzero(got[2][b] == 0)
        pos = got[2][b] > 0
        eligible = np.flatnonzero(~pos)
        assert len(neg) == 2 * pos.sum()
        # (every anchor here overlaps its gt below the mining threshold
        # or is positive, so the negatives are the first eligible ones)
        np.testing.assert_array_equal(neg, eligible[:len(neg)])


#: one gt whose only match is forced (IoU 0.36 with anchor 0; the other
#: two anchors do not overlap it)
DUP_ANCHORS = np.array([[[0, 0, .5, .5], [.5, .5, 1, 1], [0, .5, .5, 1]]],
                       np.float32)
GT = [0, 0, 0, .3, .3, 0]
PAD = [-1] * 6


@pytest.mark.parametrize("rows,mask,cls", [
    ([GT, PAD], 0.0, 0.0),      # the padding row names anchor 0 last
    ([PAD, GT], 1.0, 1.0),
    ([GT], 1.0, 1.0)], ids=["gt_pad", "pad_gt", "gt"])
def test_target_force_match_padding_row_after_a_gt(rows, mask, cls):
    """A padding row has an IoU column of -1, so it names anchor 0 as its
    best; the last row that names an anchor decides it, so a padding row
    after the gt drops the gt's forced match.  This is the JAX package's
    answer on the CPU, which the port keeps on every device."""
    label = np.array([rows], np.float32)
    pred = np.zeros((1, 2, 3), np.float32)
    got = _check_target({"overlap_threshold": 0.5}, DUP_ANCHORS, label, pred)
    assert got[1][0, 0] == mask and got[2][0, 0] == cls
    assert (got[2][0, 1:] == 0).all()


def test_target_two_rows_share_a_best_anchor():
    """Two valid rows whose best anchor is the same: the higher row's id
    and box are the anchor's target."""
    anchor = np.array([[[0, 0, .5, .5], [.5, .5, 1, 1]]], np.float32)
    label = np.array([[[1, 0, 0, .3, .3, 0], [2, .05, .05, .3, .35, 0]]],
                     np.float32)
    pred = np.zeros((1, 4, 2), np.float32)
    got = _check_target({"overlap_threshold": 0.5}, anchor, label, pred)
    assert got[2][0, 0] == 3.0 and got[1][0, 0] == 1.0


def test_last_claim_is_the_highest_row():
    best = torch.tensor([[0, 2, 0, 1], [3, 3, 3, 3]])
    np.testing.assert_array_equal(last_claim(best, 5).numpy(),
                                  [[2, 3, 1, -1, -1], [-1, -1, -1, 3, -1]])


def _detection_inputs(rng, n=3, c=4, a=50, ties=True):
    logits = rng.normal(0, 2, (n, c, a)).astype("f")
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    if ties:
        # a third of the anchors are background: score exactly 0
        prob[:, 0, ::3] = 2.0
        prob = prob / prob.sum(1, keepdims=True)
    loc = rng.normal(0, 0.5, (n, a * 4)).astype("f")
    return prob.astype("f"), loc, _anchors(rng, a)


@pytest.mark.parametrize("attrs", [
    {"nms_threshold": 0.45, "nms_topk": 20},
    {"nms_threshold": 0.3, "nms_topk": -1},
    {"nms_threshold": 0.3, "force_suppress": True, "nms_topk": 30},
    {"nms_threshold": 0.5, "background_id": 2, "clip": False,
     "threshold": 0.2}],
    ids=["topk", "all", "force", "background2"])
def test_detection_matches_jax(attrs):
    rng = np.random.RandomState(2)
    prob, loc, anchor = _detection_inputs(rng)
    (got,), (want,) = _both("_contrib_MultiBoxDetection", attrs, prob, loc,
                            anchor)
    assert got.shape == (3, 50, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0,
                               atol=TOL)
    kept = got[..., 0] >= 0
    assert kept.any() and (~kept).any()


def test_detection_ties_at_zero_keep_index_order():
    """Rows scored 0 (background) follow the scored rows in index order."""
    rng = np.random.RandomState(3)
    prob, loc, anchor = _detection_inputs(rng, n=1)
    (got,), _ = _both("_contrib_MultiBoxDetection", {}, prob, loc, anchor)
    cls = prob[0].argmax(0)
    zeros = np.flatnonzero(cls == 0)
    tail = got[0, -len(zeros):]
    assert (tail[:, 1] == 0).all() and (tail[:, 0] == -1).all()
    loc4 = loc[0].reshape(-1, 4)
    np.testing.assert_allclose(tail[:, 2], np.clip(
        (loc4[zeros, 0] * 0.1 * (anchor[0, zeros, 2] - anchor[0, zeros, 0])
         + (anchor[0, zeros, 0] + anchor[0, zeros, 2]) / 2)
        - np.exp(loc4[zeros, 2] * 0.2)
        * (anchor[0, zeros, 2] - anchor[0, zeros, 0]) / 2, 0, 1),
        atol=1e-6)


def _meta(*shapes):
    return [torch.empty(s, device="meta") for s in shapes]


def test_ops_run_on_meta_and_pass_no_gradient():
    op = get_op("_contrib_MultiBoxTarget")
    outs = op.fcompute(op.parse_attrs(TARGET), OpContext(),
                       *_meta((1, 8108, 4), (32, 7, 6), (32, 21, 8108)))
    assert [tuple(o.shape) for o in outs] == [(32, 32432), (32, 32432),
                                              (32, 8108)]
    op = get_op("_contrib_MultiBoxDetection")
    out = op.fcompute(op.parse_attrs({"nms_topk": "40"}), OpContext(),
                      *_meta((2, 21, 100), (2, 400), (1, 100, 4)))
    assert tuple(out.shape) == (2, 100, 6) and out.device.type == "meta"
    op = get_op("_contrib_MultiBoxPrior")
    out = op.fcompute(op.parse_attrs({"sizes": "(0.1, 0.2)"}), OpContext(),
                      *_meta((1, 8, 37, 37)))
    assert tuple(out.shape) == (1, 37 * 37 * 2, 4)

    rng = np.random.RandomState(4)
    prob, loc, anchor = (torch.from_numpy(x).requires_grad_()
                         for x in _detection_inputs(rng, n=2))
    det = get_op("_contrib_MultiBoxDetection")
    assert not det.fcompute(det.parse_attrs({}), OpContext(), prob, loc,
                            anchor).requires_grad
    label = torch.from_numpy(_labels(rng, 2, 3, [2, 1]))
    tgt = get_op("_contrib_MultiBoxTarget")
    outs = tgt.fcompute(tgt.parse_attrs(TARGET), OpContext(), anchor, label,
                        torch.zeros(2, 4, 50, requires_grad=True))
    assert not any(o.requires_grad for o in outs)


CORPUS = cases_of("contrib")


@pytest.mark.parametrize("case", CORPUS, ids=[c.id for c in CORPUS])
def test_corpus_case_matches_jax(case):
    """The op corpus's MultiBox cases (chip_smoke's detection_ops phase
    runs them on the card against the CPU)."""
    check_case(case)
