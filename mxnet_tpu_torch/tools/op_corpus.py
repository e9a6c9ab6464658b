"""The op corpus: one case or more for each op of the dense corpus, with
seeded inputs, for holding one route of an op against another.

:data:`CASES` lists ``Case(id, op, attrs, makers, diff, exact, train)``:
the op's attributes as a Symbol's JSON gives them, one maker a numpy input
(drawn from one ``RandomState``), the indices of the inputs the gradient
is taken for, whether the outputs must agree exactly (indices, 0/1
results, sorted values) and the op's train flag.  Ties are planted on
purpose: equal sort keys, equal maxima, values on ``clip``'s bounds and at
the kinks of relu, abs and the leaky units.  :func:`run` runs a case
through the port on a device: every output of the op (auxiliary and
``mutate`` updates included) and the gradient of ``sum(out * cot)`` over
its float outputs, ``cot`` drawn from the seed after the forward.  The
tests hold it against the JAX package's op; ``chip_smoke.py``'s
``op_corpus`` phase holds the card against the CPU.  The samplers are in
:data:`SAMPLERS`, checked by seed and moments (:func:`sampler_check`),
since a generator's bits differ between devices.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

__all__ = ["Case", "CASES", "SAMPLERS", "DETECTION_OPS", "CONTRIB_OPS",
           "CUSTOM_OP_TYPE",
           "custom_affine_classes", "inputs_of", "run", "cotangents",
           "rel_err", "compare", "sampler_check", "card_vs_cpu"]

Case = namedtuple("Case", "id op attrs makers diff exact train")


def _case(cid, op, attrs, makers, diff=(0,), exact=False, train=False):
    return Case(cid, op, attrs, makers, tuple(diff) if diff else (), exact,
                train)


# ------------------------------------------------------------ input makers
def _n(*shape):
    return lambda r: r.normal(0, 1, shape).astype(np.float32)


def _u(lo, hi, *shape):
    return lambda r: r.uniform(lo, hi, shape).astype(np.float32)


def _pos(*shape):
    return _u(0.5, 1.5, *shape)


def _ids(n, *shape):
    return lambda r: r.randint(0, n, shape).astype(np.float32)


def _ties(*shape):
    """Values on a grid of halves in [-2, 2]: many exact ties, zeros and
    halves included."""
    return lambda r: (r.randint(-4, 5, shape) / 2.0).astype(np.float32)


def _nan(*shape):
    def make(r):
        x = r.normal(0, 1, shape).astype(np.float32)
        x.flat[::3] = np.nan
        return x
    return make


def _twin(make_a, frac=0.5):
    """A pair maker's second input: the first's values at half the
    positions (ties of a binary op), fresh draws elsewhere; the pair is
    drawn as one."""
    def make(r):
        a = make_a(r)
        b = make_a(r)
        pick = r.uniform(0, 1, a.shape) < frac
        b[pick] = a[pick]
        return a, b
    return make


def inputs_of(case, seed=0):
    """The case's numpy inputs from ``RandomState(seed)`` (a pair maker
    gives two)."""
    rng = np.random.RandomState(seed)
    out = []
    for m in case.makers:
        x = m(rng)
        out.extend(x if isinstance(x, tuple) else [x])
    return out


_UNARY_INPUTS = {
    "log": _pos(3, 4), "log2": _pos(3, 4), "log10": _pos(3, 4),
    "log1p": _pos(3, 4), "sqrt": _pos(3, 4), "rsqrt": _pos(3, 4),
    "tan": _u(-1.2, 1.2, 3, 4), "arcsin": _u(-0.9, 0.9, 3, 4),
    "arccos": _u(-0.9, 0.9, 3, 4), "arctanh": _u(-0.9, 0.9, 3, 4),
    "arccosh": _u(1.1, 3.0, 3, 4), "gamma": _u(0.3, 4.0, 3, 4),
    "gammaln": _u(0.3, 4.0, 3, 4), "reciprocal": _pos(3, 4),
    "relu": _ties(3, 4), "abs": _ties(3, 4), "sign": _ties(3, 4),
    "round": _ties(3, 4), "rint": _ties(3, 4)}
_EXACT_UNARY = {"sign", "round", "rint", "ceil", "floor", "trunc", "fix"}

UNARY = ["relu", "sigmoid", "exp", "log", "log2", "log10", "log1p", "expm1",
         "sqrt", "rsqrt", "cbrt", "rcbrt", "square", "abs", "sign", "round",
         "rint", "ceil", "floor", "trunc", "fix", "reciprocal", "sin", "cos",
         "tan", "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh",
         "arcsinh", "arccosh", "arctanh", "degrees", "radians", "gamma",
         "gammaln", "erf", "softsign"]

CMP = ["equal", "not_equal", "greater", "greater_equal", "lesser",
       "lesser_equal"]


def _on_bounds(r):
    x = r.uniform(-2, 2, (4, 5)).astype(np.float32)
    x.flat[::4] = -1.0
    x.flat[1::4] = 1.0
    return x


def _smooth_inputs(r):
    x = r.uniform(-2, 2, (4, 5)).astype(np.float32)
    x.flat[::5] = 1.0
    return x


def _topk_input(r):
    return (r.randint(0, 4, (3, 7)) / 2.0).astype(np.float32)


def _scatter_idx(r):
    flat = r.choice(12, 5, replace=False)
    return np.stack(np.unravel_index(flat, (3, 4))).astype(np.float32)


def _gather_idx(r):
    return np.stack([r.randint(0, 3, 5), r.randint(0, 4, 5)]) \
        .astype(np.float32)


def _take_idx(r):
    return np.array([[0, 2, 5], [-1, 1, 3]], np.float32)


def _seq_len(r):
    return np.array([3, 1, 5], np.float32)


def _updates(n_states, sq=False):
    makers = [_n(3, 4), _n(3, 4)] + [_pos(3, 4) if sq else _n(3, 4)
                                     for _ in range(n_states)]
    return makers


CASES = (
    [_case(n, n, {}, [_UNARY_INPUTS.get(n, _n(3, 4))],
           exact=n in _EXACT_UNARY) for n in UNARY]
    + [_case("gamma_negative", "gamma", {}, [_u(-2.8, -2.2, 3, 4)]),
       _case("cast_f64", "Cast", {"dtype": "float64"}, [_n(3, 4)]),
       _case("cast_i32", "Cast", {"dtype": "int32"}, [_u(-5, 5, 3, 4)],
             diff=(), exact=True),
       _case("clip", "clip", {"a_min": -1.0, "a_max": 1.0}, [_on_bounds]),
       _case("smooth_l1", "smooth_l1", {"scalar": 1.0}, [_smooth_inputs]),
       _case("smooth_l1_s2", "smooth_l1", {"scalar": 2.0},
             [_u(-1, 1, 4, 5)])]
    # binary: element-wise pairs with ties planted, broadcast pairs
    + [_case("_" + n, "_" + n, {}, [_twin(_ties(3, 4))], diff=(0, 1))
       for n in ("maximum", "minimum")]
    + [_case("_hypot", "_hypot", {}, [_n(3, 4), _n(3, 4)], diff=(0, 1))]
    + [_case("_" + n, "_" + n, {}, [_twin(_ties(3, 4))], diff=(),
             exact=True) for n in CMP]
    + [_case("broadcast_" + n, "broadcast_" + n, {},
             [_n(2, 3, 4), _n(1, 3, 1)], diff=(0, 1))
       for n in ("sub", "mul", "hypot")]
    + [_case("broadcast_div", "broadcast_div", {},
             [_n(2, 3, 4), _pos(1, 3, 1)], diff=(0, 1)),
       _case("broadcast_mod", "broadcast_mod", {},
             [_u(-4, 4, 2, 3, 4), _u(0.7, 1.9, 1, 3, 1)], diff=(0, 1)),
       _case("broadcast_power", "broadcast_power", {},
             [_pos(2, 3, 4), _n(1, 3, 1)], diff=(0, 1))]
    + [_case("broadcast_" + n, "broadcast_" + n, {},
             [_ties(2, 3, 4), _ties(1, 3, 1)], diff=(0, 1))
       for n in ("maximum", "minimum")]
    + [_case("broadcast_" + n, "broadcast_" + n, {},
             [_ties(2, 3, 4), _ties(1, 3, 1)], diff=(), exact=True)
       for n in CMP]
    + [_case("add_n", "add_n", {"num_args": 3}, [_n(2, 3)] * 3,
             diff=(0, 1, 2))]
    # reductions, ties planted in max/min
    + [_case("sum_axis1", "sum", {"axis": 1}, [_n(2, 3, 4)]),
       _case("sum_all", "sum", {}, [_n(2, 3, 4)]),
       _case("mean_keep", "mean", {"axis": (0, 2), "keepdims": True},
             [_n(2, 3, 4)]),
       _case("prod", "prod", {"axis": 1}, [_pos(2, 3, 4)]),
       _case("prod_all", "prod", {}, [_pos(2, 3)]),
       _case("max_ties", "max", {"axis": 1}, [_ties(2, 5, 3)]),
       _case("max_all", "max", {}, [_ties(3, 4)]),
       _case("min_exclude", "min", {"axis": 1, "exclude": True},
             [_ties(2, 3, 4)]),
       _case("nansum", "nansum", {"axis": 0}, [_nan(3, 4)]),
       _case("nanprod", "nanprod", {"axis": 1}, [_nan(3, 4)]),
       _case("norm", "norm", {}, [_n(3, 4)]),
       _case("norm_l1", "norm", {"ord": 1, "axis": 1, "keepdims": True},
             [_n(3, 4)]),
       _case("argmax_ties", "argmax", {"axis": 1}, [_ties(3, 6)], diff=(),
             exact=True),
       _case("argmax_keep", "argmax", {"axis": 0, "keepdims": True},
             [_ties(4, 3)], diff=(), exact=True),
       _case("argmin_all", "argmin", {}, [_ties(3, 4)], diff=(),
             exact=True),
       _case("argmax_channel", "argmax_channel", {}, [_ties(3, 5, 2)],
             diff=(), exact=True)]
    # matrix and shape ops
    + [_case("broadcast_axis", "broadcast_axis",
             {"axis": (0, 2), "size": (3, 4)}, [_n(1, 2, 1)]),
       _case("broadcast_to", "broadcast_to", {"shape": (3, 0, 4)},
             [_n(1, 2, 1)]),
       _case("dot", "dot", {}, [_n(3, 4), _n(4, 5)], diff=(0, 1)),
       _case("dot_tb", "dot", {"transpose_b": True}, [_n(3, 4), _n(5, 4)],
             diff=(0, 1)),
       _case("dot_3d", "dot", {}, [_n(2, 3, 4), _n(4, 5)], diff=(0, 1)),
       _case("dot_vec", "dot", {"transpose_a": True}, [_n(4, 3), _n(4)],
             diff=(0, 1)),
       _case("batch_dot", "batch_dot", {"transpose_a": True},
             [_n(2, 4, 3), _n(2, 4, 5)], diff=(0, 1)),
       _case("transpose", "transpose", {}, [_n(2, 3, 4)]),
       _case("transpose_axes", "transpose", {"axes": (2, 0, 1)},
             [_n(2, 3, 4)]),
       _case("squeeze", "squeeze", {}, [_n(1, 3, 1, 2)]),
       _case("squeeze_axes", "squeeze", {"axis": (0, 2)},
             [_n(1, 3, 1, 2)]),
       _case("slice", "slice", {"begin": (1, None), "end": (3, -1)},
             [_n(4, 5)]),
       _case("slice_step", "slice", {"begin": (None, 4), "end": (None, 0),
                                     "step": (2, -2)}, [_n(5, 6)]),
       _case("flip", "flip", {"axis": 1}, [_n(2, 3, 4)]),
       _case("reverse_axes", "reverse", {"axis": (0, 2)}, [_n(2, 3, 4)]),
       _case("repeat", "repeat", {"repeats": 2, "axis": 1}, [_n(2, 3)]),
       _case("repeat_flat", "repeat", {"repeats": 3}, [_n(2, 2)]),
       _case("tile", "tile", {"reps": (2, 1, 3)}, [_n(2, 3)]),
       _case("stack", "stack", {"axis": 1, "num_args": 3}, [_n(2, 3)] * 3,
             diff=(0, 1, 2))]
    # indexing
    + [_case("take_clip", "take", {}, [_n(4, 3), _take_idx]),
       _case("take_wrap", "take", {"mode": "wrap", "axis": 1},
             [_n(2, 4), _take_idx]),
       _case("batch_take", "batch_take", {}, [_n(4, 5), _ids(5, 4)]),
       _case("one_hot", "one_hot", {"depth": 4},
             [lambda r: np.array([0, 3, -1, 4, 2], np.float32)], diff=(),
             exact=True),
       _case("one_hot_values", "one_hot",
             {"depth": 3, "on_value": 2.0, "off_value": -1.0},
             [_ids(3, 2, 3)], diff=(), exact=True),
       _case("gather_nd", "gather_nd", {}, [_n(3, 4), _gather_idx]),
       _case("scatter_nd", "scatter_nd", {"shape": (3, 4)},
             [_n(5), _scatter_idx]),
       _case("pick", "pick", {"axis": 1}, [_n(3, 4),
                                           lambda r: np.array(
                                               [0, 5, -2], np.float32)]),
       _case("pick_keep", "pick", {"axis": 0, "keepdims": True},
             [_n(3, 4), _ids(3, 4)])]
    # ordering, ties planted
    + [_case("topk_" + rt, "topk", {"k": 3, "ret_typ": rt}, [_topk_input],
             diff=(0,) if rt == "value" else (), exact=True)
       for rt in ("indices", "value", "both", "mask")]
    + [_case("topk_ascend_axis0", "topk", {"k": 2, "axis": 0,
                                           "is_ascend": True,
                                           "ret_typ": "both"},
             [_topk_input], diff=(), exact=True),
       _case("sort", "sort", {}, [_topk_input], exact=True),
       _case("sort_desc", "sort", {"is_ascend": False, "axis": 0},
             [_topk_input], exact=True),
       _case("argsort", "argsort", {}, [_topk_input], diff=(), exact=True),
       _case("argsort_desc", "argsort", {"is_ascend": False},
             [_topk_input], diff=(), exact=True),
       _case("_full", "_full", {"shape": (2, 3), "value": 1.5}, [],
             diff=(), exact=True)]
    # nn: convolutions, including the 1-d and 3-d gaps
    + [_case("deconv_stride2", "Deconvolution",
             {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1),
              "num_filter": 4}, [_n(2, 3, 4, 4), _n(3, 4, 4, 4)],
             diff=(0, 1)),
       _case("deconv_groups_adj_bias", "Deconvolution",
             {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
              "adj": (1, 1), "num_group": 2, "num_filter": 4,
              "no_bias": False},
             [_n(1, 4, 3, 3), _n(4, 2, 3, 3), _n(4)], diff=(0, 1, 2)),
       _case("deconv_1d", "Deconvolution",
             {"kernel": (3,), "stride": (2,), "num_filter": 2},
             [_n(2, 3, 5), _n(3, 2, 3)], diff=(0, 1)),
       _case("deconv_3d", "Deconvolution",
             {"kernel": (2, 2, 2), "stride": (2, 1, 1), "pad": (0, 1, 0),
              "num_filter": 2}, [_n(1, 2, 3, 3, 3), _n(2, 2, 2, 2, 2)],
             diff=(0, 1)),
       _case("conv_1d", "Convolution",
             {"kernel": (3,), "stride": (2,), "dilate": (2,), "pad": (1,),
              "num_filter": 4, "num_group": 2},
             [_n(2, 4, 9), _n(4, 2, 3), _n(4)], diff=(0, 1, 2)),
       _case("conv_3d", "Convolution",
             {"kernel": (2, 3, 3), "pad": (0, 1, 1), "num_filter": 3,
              "no_bias": True}, [_n(1, 2, 3, 4, 4), _n(3, 2, 2, 3, 3)],
             diff=(0, 1)),
       _case("pool_1d_max", "Pooling",
             {"kernel": (3,), "stride": (2,), "pad": (1,)}, [_n(2, 3, 9)]),
       _case("pool_1d_avg_full", "Pooling",
             {"kernel": (2,), "stride": (2,), "pool_type": "avg",
              "pooling_convention": "full"}, [_n(2, 3, 7)]),
       _case("pool_3d_sum", "Pooling",
             {"kernel": (2, 2, 2), "stride": (2, 2, 2), "pool_type": "sum"},
             [_n(1, 2, 4, 4, 4)]),
       _case("pool_3d_global", "Pooling",
             {"global_pool": True, "pool_type": "max"},
             [_n(1, 2, 3, 3, 3)]),
       _case("layer_norm_mean_var", "LayerNorm", {"output_mean_var": True},
             [_n(2, 3, 8), _pos(8), _n(8)], diff=(0, 1, 2))]
    # nn: normalization and activations
    + [_case("instance_norm", "InstanceNorm", {"eps": 1e-3},
             [_n(2, 3, 4, 4), _pos(3), _n(3)], diff=(0, 1, 2)),
       _case("l2norm_instance", "L2Normalization", {}, [_n(2, 3, 4)]),
       _case("l2norm_channel", "L2Normalization", {"mode": "channel"},
             [_n(2, 3, 4)]),
       _case("l2norm_spatial", "L2Normalization", {"mode": "spatial"},
             [_n(2, 3, 2, 2)]),
       _case("lrn", "LRN", {"nsize": 5}, [_n(2, 6, 3, 3)]),
       _case("lrn_3", "LRN", {"nsize": 3, "alpha": 1e-2, "beta": 0.5},
             [_n(2, 4, 2, 2)]),
       _case("leaky", "LeakyReLU", {"act_type": "leaky", "slope": 0.2},
             [_ties(3, 4)]),
       _case("prelu", "LeakyReLU", {"act_type": "prelu"},
             [_ties(2, 3, 2, 2), _pos(3)], diff=(0, 1)),
       _case("elu", "LeakyReLU", {"act_type": "elu", "slope": 0.7},
             [_n(3, 4)]),
       _case("rrelu_inference", "LeakyReLU", {"act_type": "rrelu"},
             [_n(3, 4)]),
       _case("softmax", "softmax", {"axis": 1}, [_n(2, 4, 3)]),
       _case("softmax_temperature", "softmax", {"temperature": 2.0},
             [_n(3, 5)]),
       _case("log_softmax", "log_softmax", {}, [_n(3, 5)]),
       _case("softmax_act_instance", "SoftmaxActivation", {},
             [_n(2, 3, 2)]),
       _case("softmax_act_channel", "SoftmaxActivation",
             {"mode": "channel"}, [_n(2, 3, 2, 2)])]
    # nn: loss heads (their backward ignores the head gradient)
    + [_case("linreg", "LinearRegressionOutput", {}, [_n(4, 3), _n(4, 3)],
             diff=(0, 1)),
       _case("maereg", "MAERegressionOutput", {}, [_n(4, 3), _n(4, 3)],
             diff=(0, 1)),
       _case("logreg", "LogisticRegressionOutput", {},
             [_n(4, 1), _ids(2, 4)], diff=(0, 1)),
       _case("svm", "SVMOutput", {"margin": 0.5}, [_n(4, 5), _ids(5, 4)],
             diff=(0, 1)),
       _case("svm_linear", "SVMOutput",
             {"use_linear": True, "regularization_coefficient": 0.5},
             [_n(4, 5), _ids(5, 4)], diff=(0, 1)),
       _case("make_loss", "MakeLoss", {"grad_scale": 0.5}, [_n(3, 4)]),
       _case("make_loss_batch", "MakeLoss", {"normalization": "batch"},
             [_n(3, 4)]),
       _case("make_loss_valid", "MakeLoss",
             {"normalization": "valid", "valid_thresh": 0.2}, [_n(3, 4)]),
       _case("kl_sparse_train", "IdentityAttachKLSparseReg", {},
             [_u(0.05, 0.95, 4, 3), _u(0.2, 0.8, 3)], train=True),
       _case("kl_sparse_inference", "IdentityAttachKLSparseReg",
             {"penalty": 0.01}, [_u(0.05, 0.95, 4, 3), _u(0.2, 0.8, 3)]),
       _case("lsoftmax_m2", "LSoftmax", {"margin": 2, "num_hidden": 5},
             [_n(4, 3), _n(5, 3), _ids(5, 4)], diff=(0, 1), train=True),
       _case("lsoftmax_m3", "LSoftmax", {"margin": 3, "beta": 0.5,
                                         "num_hidden": 5},
             [_n(4, 3), _n(5, 3), _ids(5, 4)], diff=(0, 1), train=True),
       _case("softmax_cross_entropy", "softmax_cross_entropy", {},
             [_n(4, 5), _ids(5, 4)])]
    # nn: the rest
    + [_case("block_grad", "BlockGrad", {}, [_n(3, 4)]),
       _case("pad_constant", "Pad",
             {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
              "constant_value": 0.5}, [_n(1, 2, 3, 3)]),
       _case("pad_edge", "Pad",
             {"mode": "edge", "pad_width": (0, 0, 0, 0, 2, 1, 1, 2)},
             [_n(1, 2, 3, 3)]),
       _case("pad_reflect", "Pad",
             {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 1, 2, 2)},
             [_n(1, 2, 3, 4)]),
       _case("upsampling", "UpSampling", {"scale": 2, "num_args": 1},
             [_n(1, 2, 3, 3)]),
       _case("upsampling_sum", "UpSampling",
             {"scale": 2, "num_args": 2, "multi_input_mode": "sum"},
             [_n(1, 2, 4, 4), _n(1, 2, 2, 2)], diff=(0, 1)),
       _case("upsampling_concat", "UpSampling",
             {"scale": 1, "num_args": 2}, [_n(1, 2, 4, 4), _n(1, 3, 2, 2)],
             diff=(0, 1)),
       _case("crop_hw", "Crop", {"h_w": (2, 3), "offset": (1, 0)},
             [_n(1, 2, 4, 5)]),
       _case("crop_center_like", "Crop",
             {"num_args": 2, "center_crop": True},
             [_n(1, 2, 5, 6), _n(1, 1, 3, 2)]),
       _case("sequence_mask", "SequenceMask",
             {"use_sequence_length": True, "value": -1.0},
             [_n(5, 3, 2), _seq_len]),
       _case("sequence_mask_off", "SequenceMask", {}, [_n(4, 3, 2)]),
       _case("sequence_last", "SequenceLast", {"use_sequence_length": True},
             [_n(5, 3, 2), _seq_len]),
       _case("sequence_last_off", "SequenceLast", {}, [_n(4, 3, 2)]),
       _case("sequence_reverse", "SequenceReverse",
             {"use_sequence_length": True}, [_n(5, 3, 2), _seq_len]),
       _case("sequence_reverse_off", "SequenceReverse", {}, [_n(4, 3)])]
    # the update ops: the new weight and the mutated states
    + [_case("sgd_update", "sgd_update",
             {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5}, _updates(0),
             diff=()),
       _case("sgd_update_clip", "sgd_update",
             {"lr": 0.1, "clip_gradient": 0.5}, _updates(0), diff=()),
       _case("sgd_mom_update", "sgd_mom_update",
             {"lr": 0.1, "momentum": 0.9, "wd": 0.01}, _updates(1),
             diff=()),
       _case("adam_update", "adam_update", {"lr": 0.01, "wd": 0.001},
             [_n(3, 4), _n(3, 4), _n(3, 4), _pos(3, 4)], diff=()),
       _case("rmsprop_update", "rmsprop_update",
             {"lr": 0.01, "clip_weights": 0.9}, _updates(1, sq=True),
             diff=()),
       _case("rmspropalex_update", "rmspropalex_update", {"lr": 0.01},
             [_n(3, 4), _n(3, 4), _u(2.0, 3.0, 3, 4), _u(-0.1, 0.1, 3, 4),
              _n(3, 4)], diff=())])

# ---------------------------------------------------- the detection path
def _corner_boxes(n, lo=0.05, hi=0.4, batch=None):
    """``n`` corner boxes in [0, 1] (a leading 1, or ``batch``, axis)."""
    def make(r):
        c = r.uniform(0.1, 0.9, (batch or 1, n, 2))
        wh = r.uniform(lo, hi, (batch or 1, n, 2))
        return np.concatenate([c - wh / 2, c + wh / 2], -1) \
            .astype(np.float32)
    return make


def _det_labels(batch, rows, objects):
    """(batch, rows, 6) detection labels padded with -1 rows, ``objects``
    valid rows an image (an image of none included)."""
    def make(r):
        lab = np.full((batch, rows, 6), -1.0, np.float32)
        for b in range(batch):
            for m in range(objects[b]):
                c = r.uniform(0.2, 0.8, 2)
                wh = r.uniform(0.1, 0.5, 2)
                lab[b, m] = [r.randint(0, 3), *(c - wh / 2), *(c + wh / 2), 0]
        return lab
    return make


def _class_probs(batch, classes, anchors):
    """Softmax class probabilities with every third anchor background
    (class 0), whose detection score is then exactly 0: ties."""
    def make(r):
        z = r.normal(0, 2, (batch, classes, anchors))
        z[:, 0, ::3] = 20.0
        p = np.exp(z - z.max(1, keepdims=True))
        return (p / p.sum(1, keepdims=True)).astype(np.float32)
    return make


def _rois(r):
    return np.array([[0, 0, 0, 7, 7], [0, 2, 2, 6, 6], [1, 1, 0, 5, 3],
                     [1, 4, 4, 4, 4], [0, 3.5, 2.5, 5.5, 6.5]], np.float32)


def _relu_ties(*shape):
    """Non-negative values with many exact zeros (after a ReLU), ties of
    a max."""
    return lambda r: np.maximum(r.randint(-3, 4, shape) / 2.0, 0.0) \
        .astype(np.float32)


def _im_info(h, w, scale=1.0):
    return lambda r: np.array([[h, w, scale]], np.float32)


def custom_affine_classes(operator):
    """A small ``CustomOp`` and its prop over ``operator`` (either
    package's module): y = scale * x + 1, whose backward gives scale *
    dy."""
    class Affine(operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        in_data[0].asnumpy() * self.scale + 1.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0].asnumpy() * self.scale)

    class AffineProp(operator.CustomOpProp):
        def __init__(self, scale="2.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, shapes, dtypes):
            return Affine(np.float32(self.scale))

    return Affine, AffineProp


#: the op_type of the corpus's Custom case
CUSTOM_OP_TYPE = "corpus_affine"


def _register_custom():
    from mxnet_tpu_torch import operator
    operator.register(CUSTOM_OP_TYPE)(custom_affine_classes(operator)[1])


_register_custom()

#: the ops of the detection path (chip_smoke holds them in their own phase)
DETECTION_OPS = frozenset([
    "_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
    "_contrib_MultiBoxDetection", "_contrib_Proposal", "ROIPooling",
    "Custom", "GridGenerator", "BilinearSampler", "SpatialTransformer",
    "Correlation"])

CASES = CASES + [
    _case("multibox_prior", "_contrib_MultiBoxPrior",
          {"sizes": (0.2, 0.272), "ratios": (1, 2, 0.5, 3, 1.0 / 3)},
          [_n(2, 3, 5, 7)], diff=()),
    _case("multibox_prior_clip_steps", "_contrib_MultiBoxPrior",
          {"sizes": (0.9,), "ratios": (1, 2), "clip": True,
           "steps": (0.1, 0.125)}, [_n(1, 2, 4, 6)], diff=()),
    _case("multibox_target", "_contrib_MultiBoxTarget",
          {"negative_mining_ratio": 3, "minimum_negative_samples": 2},
          [_corner_boxes(60), _det_labels(3, 5, (1, 4, 0)),
           _n(3, 4, 60)], diff=()),
    _case("multibox_target_plain", "_contrib_MultiBoxTarget",
          {"overlap_threshold": 0.4},
          [_corner_boxes(60), _det_labels(3, 5, (2, 5, 1)),
           _n(3, 4, 60)], diff=()),
    _case("multibox_detection_topk", "_contrib_MultiBoxDetection",
          {"nms_threshold": 0.45, "nms_topk": 20},
          [_class_probs(2, 4, 50), _n(2, 200), _corner_boxes(50)],
          diff=()),
    _case("multibox_detection_force", "_contrib_MultiBoxDetection",
          {"nms_threshold": 0.3, "force_suppress": True},
          [_class_probs(2, 4, 50), _n(2, 200), _corner_boxes(50)],
          diff=()),
    _case("proposal", "_contrib_Proposal",
          {"scales": (2.0, 4.0), "ratios": (0.5, 1.0, 2.0),
           "feature_stride": 8, "rpn_pre_nms_top_n": 30,
           "rpn_post_nms_top_n": 8, "rpn_min_size": 4},
          [_u(0, 1, 1, 12, 4, 4), _u(-0.2, 0.2, 1, 24, 4, 4),
           _im_info(32, 32)], diff=()),
    _case("proposal_score_padded", "_contrib_Proposal",
          {"scales": (4.0, 8.0), "ratios": (0.5, 1.0),
           "feature_stride": 16, "rpn_pre_nms_top_n": 20,
           "rpn_post_nms_top_n": 12, "rpn_min_size": 2,
           "output_score": True, "threshold": 0.3},
          [_u(0, 1, 1, 8, 3, 3), _u(-0.1, 0.1, 1, 16, 3, 3),
           _im_info(40, 36)], diff=()),
    _case("roi_pooling_ties", "ROIPooling",
          {"pooled_size": (2, 2), "spatial_scale": 1.0},
          [_relu_ties(2, 3, 8, 8), _rois]),
    _case("roi_pooling_scale", "ROIPooling",
          {"pooled_size": (3, 3), "spatial_scale": 0.5},
          [_n(2, 2, 6, 6), _rois]),
    _case("grid_affine", "GridGenerator",
          {"transform_type": "affine", "target_shape": (4, 5)},
          [_u(-1, 1, 2, 6)]),
    _case("grid_warp", "GridGenerator", {"transform_type": "warp"},
          [_u(-1, 1, 2, 2, 3, 4)]),
    _case("bilinear_sampler", "BilinearSampler", {},
          [_u(-1, 1, 2, 3, 5, 6), _u(-1.3, 1.3, 2, 2, 4, 4)],
          diff=(0, 1)),
    _case("spatial_transformer", "SpatialTransformer",
          {"target_shape": (5, 5)},
          [_u(-1, 1, 2, 3, 6, 6), lambda r: (np.array(
              [0.9, 0.05, 0.0, -0.05, 0.9, 0.0], np.float32)
              + r.uniform(-0.3, 0.3, (2, 6))).astype(np.float32)],
          diff=(0, 1)),
    _case("correlation", "Correlation",
          {"kernel_size": 3, "max_displacement": 2, "pad_size": 2},
          [_u(-1, 1, 2, 3, 7, 7), _u(-1, 1, 2, 3, 7, 7)], diff=(0, 1)),
    _case("correlation_abs_strided", "Correlation",
          {"kernel_size": 1, "max_displacement": 2, "stride1": 2,
           "stride2": 2, "is_multiply": False},
          [_u(-1, 1, 1, 2, 10, 10), _u(-1, 1, 1, 2, 10, 10)], diff=(0, 1)),
    _case("custom_affine", "Custom",
          {"op_type": CUSTOM_OP_TYPE, "scale": 3.0}, [_n(3, 4)])]

#: the dense contrib ops and RingAttention: chip_smoke's contrib_ops phase
#: holds their cases on the card (op_corpus leaves them out)
CONTRIB_OPS = frozenset([
    "_contrib_CTCLoss", "_contrib_quantize", "_contrib_dequantize",
    "_contrib_fft", "_contrib_ifft", "_contrib_count_sketch",
    "_contrib_SwitchMoE", "_contrib_RingAttention"])


def _const(values, dtype=np.float32):
    return lambda r: np.array(values, dtype)


def _quantize_ties(r):
    """Values on the half-integers of a unit scale (round half to even
    decides them) and past both ends of the range."""
    x = (r.randint(-4, 520, (4, 6)) / 2.0).astype(np.float32)
    x.flat[:4] = [0.5, 1.5, 2.5, 254.5]
    return x


def _uint8(*shape):
    return lambda r: r.randint(0, 256, shape).astype(np.uint8)


def _moe(tokens, d, ff, experts, batch=None):
    """SwitchMoE's data, router and expert weights (``init_moe_params``'
    draws, biases drawn too)."""
    def make(r):
        x = r.normal(0, 1, (batch, tokens, d) if batch else (tokens, d))
        return tuple(a.astype(np.float32) for a in (
            x, r.normal(0, 0.5, (d, experts)),
            r.normal(0, 0.3, (experts, d, ff)),
            r.normal(0, 0.1, (experts, ff)),
            r.normal(0, 0.3, (experts, ff, d)),
            r.normal(0, 0.1, (experts, d))))
    return make


CASES = CASES + [
    _case("ctc_repeats_padding", "_contrib_CTCLoss", {},
          [_n(8, 3, 5), _const([[1, 1, 2], [3, 0, 0], [2, 4, 2]])]),
    _case("ctc_infeasible", "_contrib_CTCLoss", {},
          [_n(3, 2, 4), _const([[1, 1, 1], [2, 3, 0]])]),
    _case("ctc_alias", "ctc_loss", {},
          [_n(5, 2, 6), _const([[5, 0], [2, 2]])]),
    _case("quantize_ties_uint8", "_contrib_quantize", {},
          [_quantize_ties, _const([0.0]), _const([255.0])], diff=(1, 2),
          exact=True),
    _case("quantize_int8", "_contrib_quantize", {"out_type": "int8"},
          [_u(-1.2, 1.2, 5, 7), _const([-1.0]), _const([1.0])],
          diff=(1, 2), exact=True),
    _case("dequantize_uint8", "_contrib_dequantize", {},
          [_uint8(4, 5), _const([-0.5]), _const([2.0])], diff=(1, 2)),
    _case("fft", "_contrib_fft", {}, [_n(3, 8)]),
    _case("ifft", "_contrib_ifft", {}, [_n(3, 16)]),
    _case("count_sketch_duplicates", "_contrib_count_sketch",
          {"out_dim": 5},
          [_n(4, 6), _const([[0, 2, 2, 1, 0, 4]]),
           _const([[1, -1, 1, 1, -1, 1]])], diff=(0, 2)),
    _case("switch_moe_drops", "_contrib_SwitchMoE",
          {"num_experts": 3, "hidden_size": 5, "capacity_factor": 0.5},
          [_moe(6, 4, 5, 3, batch=2)], diff=(0, 1, 2, 3, 4, 5)),
    _case("switch_moe_tokens", "SwitchMoE",
          {"num_experts": 4, "hidden_size": 6},
          [_moe(10, 4, 6, 4)], diff=(0, 1, 2, 3, 4, 5)),
    _case("ring_attention", "_contrib_RingAttention", {"causal": True},
          [_n(2, 8, 2, 8), _n(2, 8, 2, 8), _n(2, 8, 2, 8)],
          diff=(0, 1, 2))]

#: the samplers: (op, attrs, mean, variance) of the distribution drawn
SAMPLERS = [
    ("_random_uniform", {"low": -1.0, "high": 3.0}, 1.0, 16.0 / 12),
    ("_random_normal", {"loc": 0.5, "scale": 2.0}, 0.5, 4.0),
    ("_random_gamma", {"alpha": 0.7, "beta": 2.0}, 1.4, 2.8),
    ("_random_gamma", {"alpha": 4.0, "beta": 0.5}, 2.0, 1.0),
    ("_random_exponential", {"lam": 2.0}, 0.5, 0.25),
    ("_random_poisson", {"lam": 3.0}, 3.0, 3.0),
    ("_random_negative_binomial", {"k": 3, "p": 0.4}, 4.5, 11.25),
    ("_random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
     2.0, 4.0)]


def _port_op(name, attrs):
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op(name)
    # the attributes as a Symbol's JSON hands them: strings
    return op, op.parse_attrs({k: str(v) for k, v in attrs.items()})


def run(case, device, seed=0):
    """``(outputs, grads)`` of ``case`` through the port on ``device``
    (numpy arrays): every output of the op and the gradient of
    ``sum(out * cot)`` over its visible float outputs for each input in
    ``case.diff``."""
    import torch
    from mxnet_tpu_torch.ops.registry import OpContext, apply_op
    from mxnet_tpu_torch import random as _random
    op, attrs = _port_op(case.op, case.attrs)
    ts = [torch.tensor(x, device=device) for x in inputs_of(case, seed)]
    for i in case.diff:
        ts[i].requires_grad_(True)
    octx = OpContext(is_train=case.train, device=torch.device(device),
                     generator=_random.generator(device)
                     if op.is_stochastic(attrs) else None)
    with torch.enable_grad():
        outs = apply_op(op, attrs, octx, *ts)
    grads = []
    if case.diff:
        cot_rng = np.random.RandomState(seed + 1)
        loss = 0
        for o in outs[:op.get_num_outputs(attrs)]:
            if not o.is_floating_point():
                continue
            c = cot_rng.normal(0, 1, tuple(o.shape)).astype(np.float32)
            if o.requires_grad:
                loss = loss + (o.float() * torch.tensor(
                    c, device=device)).sum()
        diff_ts = [ts[i] for i in case.diff]
        if isinstance(loss, int):
            grads = [torch.zeros_like(t) for t in diff_ts]
        else:
            grads = [g if g is not None else torch.zeros_like(t)
                     for g, t in zip(torch.autograd.grad(
                         loss, diff_ts, allow_unused=True), diff_ts)]
    return ([o.detach().cpu().numpy() for o in outs],
            [g.detach().cpu().numpy() for g in grads])


def cotangents(shapes, seed=0):
    """The cotangents :func:`run` draws for visible float outputs of these
    shapes (for another package's vjp of the same case)."""
    cot_rng = np.random.RandomState(seed + 1)
    return [cot_rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def rel_err(got, want):
    """max |got - want| / max |want| over the finite entries (NaN must sit
    where the reference has NaN), 0 for two empty arrays."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if (np.isnan(got) != np.isnan(want)).any():
        return float("inf")
    fin = ~np.isnan(want)
    if not fin.any():
        return 0.0
    scale = max(np.abs(want[fin]).max(), 1e-30)
    return float(np.abs(got[fin] - want[fin]).max() / scale)


def compare(case, got, want):
    """The worst relative error of ``got`` against ``want`` (lists of
    outputs or gradients), inf when an exact case differs in a bit."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if case.exact and not (g.shape == w.shape and np.array_equal(
                g, w, equal_nan=g.dtype.kind == "f")):
            return float("inf")
        worst = max(worst, rel_err(g, w))
    return worst


def sampler_check(device, n=200000, seed=7, samplers=None):
    """For each sampler: the same seed draws the same bits twice, and the
    mean and variance of ``n`` draws lie within 6 standard errors of the
    distribution's (the variance's error from the fourth moment of the
    draws).  Returns one dict a sampler (of ``samplers``, default
    :data:`SAMPLERS`)."""
    import torch
    from mxnet_tpu_torch import random as _random
    from mxnet_tpu_torch.ops.registry import OpContext, apply_op
    out = []
    for name, attrs, mean, var in samplers or SAMPLERS:
        op, parsed = _port_op(name, dict(attrs, shape=(n,)))
        draws = []
        for _ in range(2):
            _random.seed(seed)
            octx = OpContext(device=torch.device(device),
                             generator=_random.generator(device))
            draws.append(apply_op(op, parsed, octx)[0].double().cpu()
                         .numpy())
        x = draws[0]
        m, v = float(x.mean()), float(x.var())
        se_m = (var / n) ** 0.5
        se_v = (max(float(((x - m) ** 4).mean()) - v * v, 0.0) / n) ** 0.5
        out.append({"op": name, "attrs": attrs,
                    "same_bits": bool(np.array_equal(draws[0], draws[1])),
                    "mean": m, "want_mean": mean, "var": v, "want_var": var,
                    "mean_z": abs(m - mean) / se_m,
                    "var_z": abs(v - var) / max(se_v, 1e-30)})
    return out


def card_vs_cpu(device="cuda", seed=0, check_device="cpu", ops=None,
                exclude=()):
    """Every case (of the ops ``ops``, when given; not of ``exclude``; an
    alias counts as its op) on
    ``device`` and on ``check_device``: one dict a case with the worst
    relative error of the outputs and of the gradients."""
    rows = []
    for case in CASES:
        name = _port_op(case.op, {})[0].name      # an alias's op
        if ops is not None and name not in ops or name in exclude:
            continue
        outs, grads = run(case, device, seed)
        ref_outs, ref_grads = run(case, check_device, seed)
        rows.append({"id": case.id, "op": name,
                     "exact": case.exact,
                     "out_err": compare(case, outs, ref_outs),
                     "grad_err": compare(case, grads, ref_grads)
                     if case.diff else None})
    return rows

