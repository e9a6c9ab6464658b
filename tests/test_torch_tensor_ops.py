"""The port's tensor ops (``mxnet_tpu_torch/ops/tensor.py``) against the
JAX package's on the CPU: every corpus case's outputs and its gradient of
``sum(out * cot)`` (``tests/torch_corpus_oracle.py``, within its ``TOL``;
indices, 0/1 results and sorted values to the bit, ties planted), then the
samplers by seed and moments and the cases the corpus cannot hold."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.tools import op_corpus

from torch_corpus_oracle import cases_of, check_case

CASES = cases_of("tensor")


def test_the_corpus_covers_the_tensor_ops():
    from mxnet_tpu_torch.ops.registry import get_op, list_ops
    ops = {n for n in list_ops()
           if get_op(n).fcompute.__module__.endswith(".tensor")}
    sampled = {s[0] for s in op_corpus.SAMPLERS}
    new = ops - {"identity", "elemwise_add", "broadcast_add", "negative",
                 "where", "_zeros", "_ones", "zeros_like", "ones_like",
                 "expand_dims", "Reshape", "slice_axis", "_arange",
                 "elemwise_sub", "elemwise_mul", "elemwise_div", "_power"} \
        - {n for n in ops if n.endswith("_scalar")}
    assert len(new) == 106
    assert new - sampled <= {c.op for c in CASES}
    assert sampled <= ops


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case):
    check_case(case)


@pytest.mark.parametrize("sampler", op_corpus.SAMPLERS,
                         ids=["%s_%d" % (s[0], i) for i, s in
                              enumerate(op_corpus.SAMPLERS)])
def test_sampler_moments_and_seed(sampler):
    """Same seed, same bits; mean and variance within 6 standard errors of
    the distribution's (the JAX package's draws differ in their bits)."""
    row, = op_corpus.sampler_check("cpu", n=40000, samplers=[sampler])
    assert row["same_bits"], sampler[0]
    assert row["mean_z"] < 6 and row["var_z"] < 6, row


def test_samplers_draw_from_the_device_generator_only():
    """``mx.random.seed`` governs every sampler, gamma's included: torch's
    global RNG is neither read nor advanced."""
    ctx = mx.cpu()
    state = torch.get_rng_state()
    draws = []
    for _ in range(2):
        mx.random.seed(3)
        torch.manual_seed(int(np.random.randint(1 << 30)))
        draws.append([mx.nd.invoke(name, shape=(64,), ctx=ctx,
                                   **attrs).asnumpy()
                      for name, attrs, _m, _v in op_corpus.SAMPLERS])
    torch.set_rng_state(state)
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a, b)
    u = mx.random.uniform(2.0, 3.0, shape=(1000,), ctx=ctx).asnumpy()
    n = mx.random.normal(1.0, 0.5, shape=(1000,), ctx=ctx).asnumpy()
    assert 2.0 <= u.min() and u.max() < 3.0
    assert abs(n.mean() - 1.0) < 0.1 and abs(n.std() - 0.5) < 0.05


def test_jax_samplers_have_the_same_moments():
    """The JAX package's draws, held to the same distributions."""
    jmx.random.seed(0)
    for name, attrs, mean, var in op_corpus.SAMPLERS:
        x = np.asarray(getattr(jmx.nd, name)(shape=(40000,), **attrs)
                       .asnumpy(), np.float64)
        assert abs(x.mean() - mean) < 6 * (var / x.size) ** 0.5, name


def test_scatter_nd_with_duplicate_indices_keeps_one_write():
    """Undefined in both packages: each duplicated position holds one of
    the values written there, the others hold theirs or zero."""
    data = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    idx = np.array([[0, 0, 1, 2], [1, 1, 0, 2]], np.float32)
    out = mx.nd.scatter_nd(mx.nd.array(data, ctx=mx.cpu()),
                           mx.nd.array(idx, ctx=mx.cpu()),
                           shape=(3, 3)).asnumpy()
    jout = jmx.nd.scatter_nd(jmx.nd.array(data), jmx.nd.array(idx),
                             shape=(3, 3)).asnumpy()
    for o in (out, jout):
        assert o[0, 1] in (1.0, 2.0)
        assert o[1, 0] == 3.0 and o[2, 2] == 4.0
        assert np.count_nonzero(o) == 3


def test_sort_ties_on_the_signed_zero():
    """topk orders -0.0 below +0.0, as lax.top_k does; sort and argsort
    take them as equal (stable), as jnp.argsort does."""
    x = np.array([[-0.0, 0.0, 1.0, -0.0, 0.0]], np.float32)
    t = mx.nd.array(x, ctx=mx.cpu())
    j = jmx.nd.array(x)
    for kw in ({"k": 5, "ret_typ": "indices"},
               {"k": 5, "ret_typ": "indices", "is_ascend": True}):
        np.testing.assert_array_equal(mx.nd.topk(t, **kw).asnumpy(),
                                      jmx.nd.topk(j, **kw).asnumpy())
    for kw in ({}, {"is_ascend": False}):
        np.testing.assert_array_equal(mx.nd.argsort(t, **kw).asnumpy(),
                                      jmx.nd.argsort(j, **kw).asnumpy())
