"""Every ported op's forward against the JAX package's on the same inputs
(f32, rtol=1e-5, atol=1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import OpContext as JaxOpContext, \
    get_op as jax_get_op

from mxnet_tpu_torch.ops.registry import OpContext, get_op, list_ops


def _n(*shape):
    def make(rng):
        return rng.normal(0, 1, shape).astype(np.float32)
    return make


def _ids(n, *shape):
    def make(rng):
        return rng.randint(0, n, shape).astype(np.float32)
    return make


def _pos(*shape):
    def make(rng):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return make


# (case id, op name, attrs, input makers)
CASES = [
    ("elemwise_add", "elemwise_add", {}, [_n(2, 3, 4), _n(2, 3, 4)]),
    ("broadcast_add", "broadcast_add", {}, [_n(2, 3, 4), _n(1, 3, 4)]),
    ("expand_dims", "expand_dims", {"axis": 0}, [_n(3, 4)]),
    ("reshape_split_heads", "Reshape", {"shape": (0, 0, 3, 2, -1)},
     [_n(2, 5, 12)]),
    ("reshape_merge_keep", "Reshape", {"shape": (0, 0, -3, -2)},
     [_n(2, 5, 1, 2, 2)]),
    ("reshape_flatten", "Reshape", {"shape": (-1, 4)}, [_n(2, 3, 4)]),
    ("reshape_divide", "Reshape", {"shape": (-4, 2, -1, 0)}, [_n(6, 5)]),
    ("slice_axis", "slice_axis", {"axis": 2, "begin": 1, "end": 2},
     [_n(2, 5, 3, 4)]),
    ("slice_axis_negative", "slice_axis", {"axis": 1, "begin": -3,
                                           "end": None}, [_n(2, 5, 3)]),
    ("arange", "_arange", {"start": 0, "stop": 16}, []),
    ("arange_repeat", "_arange", {"start": 2.0, "stop": 5.0, "step": 0.5,
                                  "repeat": 2}, []),
    ("fully_connected", "FullyConnected", {"num_hidden": 5},
     [_n(4, 3, 2), _n(5, 6), _n(5)]),
    ("fully_connected_3d", "FullyConnected", {"num_hidden": 5,
                                              "flatten": False},
     [_n(2, 3, 6), _n(5, 6), _n(5)]),
    ("fully_connected_no_bias", "FullyConnected", {"num_hidden": 5,
                                                   "no_bias": True},
     [_n(4, 6), _n(5, 6)]),
    ("layer_norm", "LayerNorm", {}, [_n(2, 3, 8), _pos(8), _n(8)]),
    ("layer_norm_axis", "LayerNorm", {"axis": 1, "eps": 1e-3},
     [_n(2, 8, 3), _pos(8), _n(8)]),
    ("activation_relu", "Activation", {"act_type": "relu"}, [_n(3, 4)]),
    ("dropout_inference", "Dropout", {"p": 0.1}, [_n(3, 4)]),
    ("softmax_output", "SoftmaxOutput", {}, [_n(4, 10), _ids(10, 4)]),
    ("embedding", "Embedding", {"input_dim": 10, "output_dim": 4},
     [_ids(10, 2, 5), _n(10, 4)]),
    ("flash_attention", "_contrib_FlashAttention", {"causal": True},
     [_n(2, 128, 2, 16)] * 3),
    ("convolution", "Convolution", {"kernel": (3, 3), "pad": (1, 1),
                                    "num_filter": 4},
     [_n(2, 3, 6, 6), _n(4, 3, 3, 3), _n(4)]),
    ("pooling_max", "Pooling", {"kernel": (3, 3), "stride": (2, 2),
                                "pad": (1, 1)}, [_n(2, 3, 7, 7)]),
    ("batch_norm_inference", "BatchNorm", {"fix_gamma": False},
     [_n(2, 3, 4, 4), _pos(3), _n(3), _n(3), _pos(3)]),
    ("flatten", "Flatten", {}, [_n(2, 3, 2, 2)]),
    ("identity", "identity", {}, [_n(3, 4)]),
    # the RNN family's (gradients in test_torch_cell_ops.py and
    # test_torch_rnn.py)
    ("elemwise_sub", "elemwise_sub", {}, [_n(2, 3), _n(2, 3)]),
    ("elemwise_mul", "elemwise_mul", {}, [_n(2, 3), _n(2, 3)]),
    ("elemwise_div", "elemwise_div", {}, [_n(2, 3), _pos(2, 3)]),
    ("power", "_power", {}, [_pos(2, 3), _n(2, 3)]),
    ("negative", "negative", {}, [_n(2, 3)]),
    ("where", "where", {}, [_ids(2, 2, 3), _n(2, 3), _n(2, 3)]),
    ("zeros", "_zeros", {"shape": (2, 3)}, []),
    ("ones", "_ones", {"shape": (3,)}, []),
    ("zeros_like", "zeros_like", {}, [_n(2, 3)]),
    ("ones_like", "ones_like", {}, [_n(2, 3)]),
    ("concat", "Concat", {"num_args": 2, "dim": 1}, [_n(2, 3), _n(2, 4)]),
    ("slice_channel", "SliceChannel", {"num_outputs": 2, "axis": 1,
                                       "squeeze_axis": False}, [_n(2, 4)]),
    ("swap_axis", "SwapAxis", {"dim1": 0, "dim2": 1}, [_n(2, 3, 4)]),
    ("rnn_lstm", "RNN", {"state_size": 3, "num_layers": 2, "mode": "lstm",
                         "state_outputs": True},
     [_n(4, 2, 5), _n(4 * 3 * (5 + 3) + 4 * 3 * (3 + 3) + 4 * 4 * 3),
      _n(2, 2, 3), _n(2, 2, 3)]),
] + [("scalar" + name, name, {"scalar": 0.5}, [_pos(2, 3)])
     for name in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
                  "_mul_scalar", "_div_scalar", "_rdiv_scalar",
                  "_power_scalar", "_rpower_scalar", "_maximum_scalar",
                  "_minimum_scalar", "_mod_scalar", "_equal_scalar",
                  "_not_equal_scalar", "_greater_scalar",
                  "_greater_equal_scalar", "_lesser_scalar",
                  "_lesser_equal_scalar")]


def test_every_ported_op_has_a_case():
    """This file's cases and the op corpus's (held against the JAX ops in
    test_torch_tensor_ops.py and test_torch_nn_corpus.py) cover every op
    of the port; the samplers are checked by their moments there."""
    from mxnet_tpu_torch.tools.op_corpus import CASES as CORPUS, SAMPLERS
    covered = {c[1] for c in CASES} | {get_op(c.op).name for c in CORPUS} \
        | {s[0] for s in SAMPLERS}
    assert covered == set(list_ops())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _cid, name, attrs, makers = case
    rng = np.random.RandomState(0)
    inputs = [m(rng) for m in makers]
    jop = jax_get_op(name)
    want = jop.fcompute(jop.parse_attrs(attrs), JaxOpContext(),
                        *[jnp.asarray(x) for x in inputs])
    op = get_op(name)
    # the port parses the attrs from strings, as a loaded JSON hands them
    raw = {k: str(v) for k, v in attrs.items()}
    got = op.fcompute(op.parse_attrs(raw), OpContext(),
                      *[torch.from_numpy(x) for x in inputs])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
