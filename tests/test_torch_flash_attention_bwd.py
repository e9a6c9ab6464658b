"""The port's flash-attention backward against the JAX package's.

On the CPU the wrapper takes its plain version; it is held against the
Pallas backward run in interpret mode (panel and streamed forms).  The
autograd function and the op are held against autograd through the plain
attention and ``jax.vjp`` of the JAX op.  The ``cuda`` test holds the CUDA
kernel against the plain version on the card.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import OpContext as JaxOpContext, \
    get_op as jax_get_op

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops.registry import OpContext, get_op

RTOL, ATOL = 2e-4, 2e-5          # as tests/test_pallas.py


def _arrays(B=2, T=128, H=2, D=64, seed=0):
    """q, k, v and the output gradient g, from a seed."""
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, (B, T, H, D)).astype(np.float32)
            for _ in range(4)]


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _check_against_pallas(q, k, v, g, causal):
    o_j, lse_j = pk._flash_attention_fwd_pallas(q, k, v, causal,
                                                interpret=True)
    want = pk._flash_attention_bwd_pallas(q, k, v, o_j, lse_j, g, causal,
                                          interpret=True)
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(*_torch(q, k, v, o_j, lse_j, g), causal)
    assert tfa.flash_attention_bwd.launches == before   # CPU: no launch
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and x.shape == q.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(y), RTOL, ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_pallas_panel_kernel(causal):
    q, k, v, g = _arrays()
    assert pk._blocks(128)[1] == 128          # one K block: the panel form
    _check_against_pallas(q, k, v, g, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_pallas_streamed_kernel(causal, monkeypatch):
    monkeypatch.setattr(pk, "_BLOCK_K", 256)  # T=512 -> 2 K blocks
    q, k, v, g = _arrays(B=1, T=512, H=2, D=32)
    assert pk._blocks(512) == (128, 256)
    _check_against_pallas(q, k, v, g, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_autograd_of_plain_attention(causal):
    q, k, v, g = _torch(*_arrays(B=1, T=128, H=2, D=32, seed=1))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.FlashAttention.apply(*leaves, causal)
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = tfa.attention_plain(*ref_leaves, causal)
    want = torch.autograd.grad(ref, ref_leaves, g)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               RTOL, ATOL)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), RTOL, ATOL)


def test_op_records_a_gradient_through_the_flash_path():
    """The op on a gated shape goes through FlashAttention, so autograd sees
    it: the gradients of q, k, v equal jax.vjp of the JAX op."""
    q, k, v, g = _arrays(B=1, T=128, H=2, D=32, seed=2)
    jop = jax_get_op("_contrib_FlashAttention")
    attrs = jop.parse_attrs({"causal": True})
    _, vjp = jax.vjp(lambda a, b, c: jop.fcompute(attrs, JaxOpContext(),
                                                  a, b, c), q, k, v)
    want = vjp(g)
    op = get_op("_contrib_FlashAttention")
    leaves = [x.requires_grad_() for x in _torch(q, k, v)]
    out = op.fcompute(op.parse_attrs({"causal": "True"}), OpContext(),
                      *leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), RTOL, ATOL)


def test_lse_layout_contract():
    """lse is (B*H, T, 1) f32 with row b*H + h: the log-sum-exp of that
    head's scaled scores, the layout the backward reads."""
    B, T, H, D = 2, 64, 3, 32
    q, k, v, _ = _torch(*_arrays(B=B, T=T, H=H, D=D, seed=3))
    _, lse = tfa.flash_attention_fwd(q, k, v, True)
    assert lse.shape == (B * H, T, 1) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(),
                      float("-inf"))
    want = torch.logsumexp(s, -1)
    for b in range(B):
        for h in range(H):
            np.testing.assert_allclose(lse[b * H + h, :, 0].numpy(),
                                       want[b, h].numpy(), RTOL, ATOL)


def test_bwd_plain_reads_strided_do():
    """Autograd may hand over dO with any strides; the result does not
    depend on them."""
    q, k, v, g = _torch(*_arrays(B=1, T=64, H=2, D=32, seed=4))
    o, lse = tfa.flash_attention_fwd(q, k, v, True)
    g_t = g.transpose(2, 3).contiguous().transpose(2, 3)
    assert not g_t.is_contiguous()
    for x, y in zip(tfa.flash_attention_bwd(q, k, v, o, lse, g_t, True),
                    tfa.flash_attention_bwd(q, k, v, o, lse, g, True)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), RTOL, ATOL)


@pytest.mark.parametrize("bad", ["lse_shape", "lse_dtype", "do_dtype",
                                 "head_dim"])
def test_bwd_kernel_argument_checks(bad):
    """The kernel path checks before it builds or launches anything."""
    q, k, v, g = _torch(*_arrays(B=1, T=64, H=2, D=64, seed=5))
    o, lse = tfa.flash_attention_plain(q, k, v, True)
    if bad == "lse_shape":
        lse = lse.reshape(1, 2, 64)
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "do_dtype":
        g = g.double()
    else:
        q, k, v, o, g = (x[..., :48] for x in (q, k, v, o, g))
    with pytest.raises(MXNetError):
        tfa._launch_bwd(q, k, v, o, lse, g, True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_kernel_matches_plain_on_card(cuda_device, dtype, causal):
    dt = getattr(torch, dtype)
    q, k, v, g = (x.to(cuda_device, dt) for x in
                  _torch(*_arrays(B=2, T=320, H=2, D=64)))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal)
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(q, k, v, o, lse, g, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 1
    want = tfa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                         o.float(), lse, g.float(), causal)
    for x, y in zip(got, want):
        ref = y.abs().max().item()
        tol = 1e-4 * ref + 1e-5 if dt == torch.float32 else 2e-2 * ref
        assert (x.float() - y).abs().max().item() <= tol
