"""K5 (``matmul_stats``): the port's plain version against the JAX package's
Pallas kernel run in interpret mode, at shapes its TPU gate admits
(N % 128 == 0, K % 8 == 0), and against the JAX fallback at N = 64.

Tolerances.  f32: y by rtol 1e-5, atol 1e-6; the sums by rtol 1e-5 of
their largest entry (both sum 256 to 512 f32 terms in other orders).  bf16:
y within one bf16 ulp of the JAX y plus 1e-5 of its largest entry (both
round an f32 accumulator once; the accumulators differ by the f32 rounding
of sums whose terms reach that size, more than an ulp of an entry near 0),
s1 and s2 by relative norm 1e-4.  The ``cuda`` test holds the CUDA kernel
against the plain version on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import fused as jfused

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused as tfused

# (M, K, N): two shapes the Pallas gate takes, one (N = 64) it leaves to
# the fallback, as ResNet-50's stage-1 blocks are left on a TPU
PALLAS_SHAPES = [(256, 64, 128), (512, 256, 256)]
FALLBACK_SHAPES = [(512, 256, 64)]


def _inputs(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = (rng.normal(0, 1, (k, n)) / np.sqrt(k)).astype(np.float32)
    c = rng.normal(0, 0.5, (n,)).astype(np.float32)
    return x, w, c


def _both(m, k, n, dtype, interpret):
    """(port plain result, JAX result) on the same inputs, as numpy f32."""
    x, w, c = _inputs(m, k, n)
    jx = jnp.asarray(x).astype(dtype)
    jw = jnp.asarray(w).astype(dtype)
    want = jfused.matmul_stats(jx, jw, jnp.asarray(c), interpret=interpret)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))) \
        .to(getattr(torch, dtype))
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))) \
        .to(getattr(torch, dtype))
    before = tfused.matmul_stats.launches
    got = tfused.matmul_stats(tx, tw, torch.from_numpy(c))
    assert tfused.matmul_stats.launches == before   # the CPU takes plain
    assert got[0].dtype == tx.dtype and got[1].dtype == torch.float32
    return ([g.float().numpy() for g in got],
            [np.asarray(v.astype(jnp.float32)) for v in want])


def _check(got, want, dtype):
    (y, s1, s2), (wy, ws1, ws2) = got, want
    assert y.shape == wy.shape and s1.shape == ws1.shape == s2.shape
    if dtype == "float32":
        np.testing.assert_allclose(y, wy, rtol=1e-5, atol=1e-6)
        for s, ws in ((s1, ws1), (s2, ws2)):
            np.testing.assert_allclose(s, ws, rtol=0,
                                       atol=1e-5 * np.abs(ws).max())
        return
    # one bf16 ulp of each JAX value, 2^(exponent - 7), and the f32 sums'
    # rounding
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(wy), 1e-30))) - 7)
    assert (np.abs(y - wy) <= ulp + 1e-5 * np.abs(wy).max()).all()
    for s, ws in ((s1, ws1), (s2, ws2)):
        assert np.linalg.norm(s - ws) <= 1e-4 * np.linalg.norm(ws)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=str)
def test_plain_matches_the_pallas_kernel(shape, dtype):
    _check(*_both(*shape, dtype, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FALLBACK_SHAPES, ids=str)
def test_plain_matches_the_jax_fallback(shape, dtype):
    _check(*_both(*shape, dtype, interpret=False), dtype)


def test_statistics_come_from_the_f32_accumulator():
    """In bf16 the sums are of the f32 product, not of the rounded y."""
    x, w, c = (torch.from_numpy(a) for a in _inputs(256, 64, 128))
    xb, wb = x.bfloat16(), w.bfloat16()
    y, s1, _s2 = tfused.matmul_stats(xb, wb, c)
    exact = (xb.double() @ wb.double() - c.double()).sum(0)
    rounded = (y.double() - c.double()).sum(0)
    err = (s1.double() - exact).abs().max().item()
    assert err < 1e-3 < (rounded - exact).abs().max().item()


def test_meta_tensors_take_the_plain_version():
    x = torch.empty(64, 32, device="meta")
    w = torch.empty(32, 16, device="meta")
    y, s1, s2 = tfused.matmul_stats(x, w, torch.empty(16, device="meta"))
    assert y.shape == (64, 16) and s1.shape == s2.shape == (16,)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1000, 72, 200), (4096, 256, 64),
                                   (300, 30, 70)], ids=str)
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    """Ragged M and N, K not a multiple of the tile depth, and (K = 30) the
    unvectorized loads."""
    dt = getattr(torch, dtype)
    x, w, c = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(*shape))
    x, w = x.to(dt), w.to(dt)
    before = tfused.matmul_stats.launches
    y, s1, s2 = tfused.matmul_stats(x, w, c)
    torch.cuda.synchronize()
    assert tfused.matmul_stats.launches == before + 1
    ry, rs1, rs2 = tfused.matmul_stats_plain(x, w, c)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert (y.float() - ry.float()).abs().max().item() \
        <= tol * ry.float().abs().max().item()
    for s, r in ((s1, rs1), (s2, rs2)):
        assert (s - r).norm().item() <= 1e-4 * r.norm().item()


def test_wrapper_refuses_mismatched_inputs():
    """The CUDA path checks its inputs before it builds anything."""
    x, w = torch.zeros(8, 4), torch.zeros(4, 3)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        tfused._launch(x.double(), w.double(), torch.zeros(3))
    with pytest.raises(MXNetError, match="c must be"):
        tfused._launch(x, w, torch.zeros(4))
    with pytest.raises(MXNetError, match="need x"):
        tfused._launch(x, torch.zeros(5, 3), torch.zeros(3))
