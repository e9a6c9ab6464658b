"""The port's dense contrib ops (``ops/contrib_dense.py``: CTCLoss,
quantize/dequantize, fft/ifft, count_sketch, SwitchMoE, with
``parallel/moe.py``) and ``_contrib_RingAttention`` against the JAX
package's, on the CPU.

The op corpus's cases of these ops (``op_corpus.CONTRIB_OPS``) go through
both packages, forward and the gradient of ``sum(out * cot)`` against
``jax.vjp``, within ``torch_corpus_oracle.TOL`` (1e-5 of the largest
entry); the quantize cases to the bit.  They cover CTC with repeated
labels and padding, an infeasible CTC alignment, quantize's ties,
count_sketch's duplicate buckets and SwitchMoE's capacity drops.  Then
the rules the cases cannot show: SwitchMoE's tied router (first expert),
its drops in token order, RingAttention equal to FlashAttention to the
bit, the GPT's ``attention="ring"`` graph (a ring step equal to the
flash step: chip_smoke's ring_gpt in ``test_torch_zoo_tools.py``), and
the shape rules on ``meta``.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.parallel import moe as jmoe

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import gpt
from mxnet_tpu_torch.ops.registry import OpContext, get_op
from mxnet_tpu_torch.parallel import moe
from mxnet_tpu_torch.tools.op_corpus import CASES, CONTRIB_OPS

from torch_corpus_oracle import check_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples", "transformer"))

import train_lm  # noqa: E402

CONTRIB = [c for c in CASES if get_op(c.op).name in CONTRIB_OPS]


@pytest.mark.parametrize("case", CONTRIB, ids=[c.id for c in CONTRIB])
def test_op_matches_jax(case):
    check_case(case)


def test_the_cases_cover_the_ops():
    assert {get_op(c.op).name for c in CONTRIB} == CONTRIB_OPS


def _op(name, *inputs, **attrs):
    op = get_op(name)
    return op.fcompute(op.parse_attrs({k: str(v) for k, v in attrs.items()}),
                       OpContext(), *inputs)


def test_ctc_infeasible_alignment_costs_1e30_not_inf():
    """Three frames cannot hold 1 1 1 (a blank between repeats): the
    recursion's -1e30 gives a loss of about 1e30, where torch's ctc_loss
    gives inf."""
    data = torch.zeros(3, 1, 4)
    loss = _op("_contrib_CTCLoss", data, torch.tensor([[1.0, 1.0, 1.0]]))
    assert torch.isfinite(loss).all() and loss.item() >= 1e29


def test_ctc_blank_last_raises():
    with pytest.raises(MXNetError, match="blank_label='first'"):
        _op("_contrib_CTCLoss", torch.zeros(3, 1, 4),
            torch.tensor([[1.0]]), blank_label="last")


def test_quantize_rounds_ties_to_even_and_clips():
    q, lo, hi = _op("_contrib_quantize",
                    torch.tensor([0.5, 1.5, 2.5, -3.0, 300.0]),
                    torch.tensor([0.0]), torch.tensor([255.0]))
    assert q.dtype == torch.uint8 and q.tolist() == [0, 2, 2, 0, 255]
    q8, _, _ = _op("_contrib_quantize", torch.tensor([-2.0, -1.0, 1.0, 2.0]),
                   torch.tensor([-1.0]), torch.tensor([1.0]),
                   out_type="int8")
    assert q8.dtype == torch.int8 and q8.tolist() == [-128, -128, 127, 127]


def test_count_sketch_sums_duplicate_buckets():
    x = torch.arange(1.0, 5.0)[None]
    out = _op("_contrib_count_sketch", x, torch.tensor([[1.0, 1.0, 0.0, 1.0]]),
              torch.tensor([[1.0, -1.0, 1.0, 1.0]]), out_dim=3)
    assert out.tolist() == [[3.0, 1.0 - 2.0 + 4.0, 0.0]]


def _moe_params(seed, d, ff, e):
    p = moe.init_moe_params(np.random.RandomState(seed), d, ff, e)
    assert all(np.array_equal(p[k], v) for k, v in jmoe.init_moe_params(
        np.random.RandomState(seed), d, ff, e).items())
    return p


def test_switch_moe_drops_match_jax():
    """tests/test_moe.py's capacity case: two slots an expert, the rest of
    the tokens give zero rows, the same rows in both packages."""
    p = _moe_params(1, 8, 16, 2)
    x = np.random.RandomState(1).randn(32, 8).astype("f")
    y, aux = moe.switch_moe(torch.from_numpy(x), **{
        k: torch.from_numpy(v) for k, v in p.items()},
        capacity_factor=2.0 / 16)
    jy, jaux = jmoe.switch_moe(jnp.asarray(x), **{
        k: jnp.asarray(v) for k, v in p.items()}, capacity_factor=2.0 / 16)
    kept = (y.abs().sum(-1) > 1e-7).numpy()
    assert 0 < kept.sum() <= 4
    assert np.array_equal(kept, np.abs(np.asarray(jy)).sum(-1) > 1e-7)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_switch_moe_tied_router_takes_the_first_expert_in_token_order():
    """Experts 0 and 1 tie on every token (identical router columns): all
    go to expert 0, whose three slots take the first three tokens."""
    p = _moe_params(4, 4, 6, 3)
    p["router_w"][:, 1] = p["router_w"][:, 0]
    p["router_w"][:, 2] = -10.0
    x = np.abs(np.random.RandomState(4).randn(8, 4)).astype("f")
    y, _ = moe.switch_moe(torch.from_numpy(x), **{
        k: torch.from_numpy(v) for k, v in p.items()},
        capacity_factor=9.0 / 8)            # ceil(8 / 3 * 9 / 8) = 3
    kept = (y.abs().sum(-1) > 0).tolist()
    assert kept == [True] * 3 + [False] * 5
    jy, _ = jmoe.switch_moe(jnp.asarray(x), **{
        k: jnp.asarray(v) for k, v in p.items()}, capacity_factor=9.0 / 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)


def test_expert_mesh_is_not_yet_ported():
    with pytest.raises(MXNetError, match="not yet ported"):
        moe.make_expert_mesh(2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_is_flash_to_the_bit(causal):
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 2, 8).astype("f"))
               .requires_grad_() for _ in range(3))
    cot = torch.from_numpy(rng.randn(2, 16, 2, 8).astype("f"))
    outs = []
    for name in ("_contrib_RingAttention", "_contrib_FlashAttention"):
        o = _op(name, q, k, v, causal=causal)
        outs.append([o] + list(torch.autograd.grad((o * cot).sum(),
                                                   (q, k, v))))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_gpt_ring_graph_is_the_examples():
    with jmx.name.NameManager():
        want = train_lm.gpt_symbol(64, 16, d_model=16, n_heads=2,
                                   n_layers=2, attention="ring").tojson()
    with tmx.name.NameManager():
        got = gpt.gpt_symbol(64, 16, d_model=16, n_heads=2, n_layers=2,
                             attention="ring").tojson()
    assert got == want and "_contrib_RingAttention" in got


def _moe_net(mx):
    data = mx.sym.Variable("data")
    y = mx.sym._contrib_SwitchMoE(data, num_experts=4, hidden_size=8,
                                  name="moe")
    c = mx.sym.Variable("label")
    ctc = mx.sym.CTCLoss(mx.sym.transpose(y[0], axes=(1, 0, 2)), c,
                         name="ctc")
    return mx.sym.Group([mx.sym.MakeLoss(ctc), y[1]])


def test_shape_rules_run_on_meta():
    """SwitchMoE's parameter shapes and CTC's output, inferred by running
    the graph on ``meta``, equal the JAX package's."""
    shapes = {"data": (3, 7, 6), "label": (3, 2)}
    with jmx.name.NameManager():
        want = _moe_net(jmx).infer_shape(**shapes)
    with tmx.name.NameManager():
        got = _moe_net(tmx).infer_shape(**shapes)
    for g, w in zip(got, want):
        assert [tuple(s) for s in g] == [tuple(s) for s in w]
    assert [tuple(s) for s in got[1]] == [(3,), ()]
