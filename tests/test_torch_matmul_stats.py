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

The padding rule (``pad_operands``: bf16 shapes TMA does not take, K or N
not a multiple of 8, are zero-padded before the launch) is held on the
CPU through the plain version: the first N columns of the padded y equal
the unpadded y exactly, the sums agree to 1e-6 by relative norm (the same
f32 terms summed in another order over a wider tensor), and both agree
with the JAX ``matmul_stats`` at the unpadded shape by the tolerances
above.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import fused as jfused

import chip_smoke
from mxnet_tpu_torch import cuda_build
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


# (M, K, N) with K or N not a multiple of 8: the bf16 kernel's TMA needs
# 16-byte row strides, so the wrapper pads these
ODD_SHAPES = [(300, 30, 70), (64, 7, 9), (513, 130, 30), (256, 64, 100)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=str)
def test_padding_keeps_the_function(shape, dtype):
    m, k, n = shape
    dt = getattr(torch, dtype)
    x, w, c = _inputs(m, k, n)
    tx = torch.from_numpy(x).to(dt)
    tw = torch.from_numpy(w).to(dt)
    tc = torch.from_numpy(c)
    xp, wp, cp, scale, shift = tfused.pad_operands(tx, tw, tc)
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    assert xp.shape == (m, kp) and wp.shape == (kp, np_)
    assert cp.shape == (np_,) and scale is None and shift is None
    # w as the kernel reads it: the (Np, Kp) rows, contiguous
    assert wp.t().is_contiguous()
    assert torch.equal(xp[:, :k], tx) and not xp[:, k:].any()
    assert torch.equal(wp[:k, :n], tw) and not wp[k:].any() \
        and not wp[:, n:].any() and not cp[n:].any()
    y, s1, s2 = tfused.matmul_stats_plain(tx, tw, tc)
    yp, s1p, s2p = tfused.matmul_stats_plain(xp, wp, cp)
    assert torch.equal(yp[:, :n], y) and not yp[:, n:].float().any()
    for got, want in ((s1p, s1), (s2p, s2)):
        assert not got[n:].any()
        assert (got[:n] - want).norm() <= 1e-6 * want.norm()
    jx = jnp.asarray(x).astype(dtype)
    jw = jnp.asarray(w).astype(dtype)
    eligible = n % 128 == 0 and k % 8 == 0
    want = jfused.matmul_stats(jx, jw, jnp.asarray(c), interpret=eligible)
    _check([yp[:, :n].float().numpy(), s1p[:n].numpy(), s2p[:n].numpy()],
           [np.asarray(v.astype(jnp.float32)) for v in want], dtype)


def test_padding_leaves_vectors_it_is_not_given():
    """K8's scale and shift pad with zeros to Kp (relu(0 * 0 + 0) = 0 on
    the padded depth columns); a missing c stays missing."""
    x, w = torch.ones(4, 6), torch.ones(6, 5)
    _x, _w, c, scale, shift = tfused.pad_operands(
        x, w, None, torch.full((6,), 2.0), torch.full((6,), 3.0))
    assert c is None
    assert scale.tolist() == [2.0] * 6 + [0.0] * 2
    assert shift.tolist() == [3.0] * 6 + [0.0] * 2


def _k5_source():
    csrc = Path(cuda_build.__file__).parent / "csrc"
    return ((csrc / "matmul_stats.cu").read_text(),
            (csrc / "sm90_common.cuh").read_text())


def test_bf16_kernel_is_one_hopper_design():
    """The bf16 path is a persistent wgmma kernel fed by a TMA/mbarrier
    ring with y stored by TMA: no mma.sync or cp.async design beside it,
    and no library call."""
    src, common = _k5_source()
    assert cuda_build.SOURCES["matmul_stats"] == "csrc/matmul_stats.cu"
    assert '#include "sm90_common.cuh"' in src
    for used in ("wgmma_ss<0, 0>(acc", "tma_load_2d(", "tma_store_2d(",
                 "mbar_wait(&full[s]", "mbar_arrive(&empty[",
                 "mbar_expect_tx(", "setmaxnreg_inc<CONSUMER_REGS>",
                 "setmaxnreg_dec<PRODUCER_REGS>", "fence_proxy_async();",
                 "bulk_wait_read<0>();", "stats_reduce_kernel<<<",
                 "int mxtt_matmul_stats(", "int mxtt_matmul_stats_prologue("):
        assert used in src, used
    for gone in ("mma.sync", "cp.async.cg", "cp.async.commit_group",
                 "cp_async", "ldmatrix", "atomicAdd"):
        assert gone not in src, gone
    assert not re.search(r"cublas|cutlass", src, re.I)
    assert "wgmma.mma_async.sync.aligned.m64n256k16" in common
    assert "cp.async.bulk.tensor.2d.shared::cluster.global" in common
    assert "cp.async.bulk.tensor.2d.global.shared::cta" in common
    # the ring: STAGES full and empty barriers, at least three stages
    assert "__shared__ uint64_t full[STAGES], empty[STAGES];" in src
    assert 'static_assert(STAGES >= 3' in src


def test_f32_route_is_split_tf32_on_the_tensor_cores():
    """The f32 route: its own kernel template in matmul_stats.cu on the
    m16n8k8 TF32 products of tf32_common.cuh (hi rounded by cvt.rna, three
    products), fed by TMA (cp.async.bulk.tensor) through an mbarrier ring,
    y stored by TMA, each stage's products summed in a zeroed accumulator
    and added on the CUDA cores; the CUDA-core FMA kernel is gone."""
    src, common = _k5_source()
    tf32 = (Path(cuda_build.__file__).parent / "csrc"
            / "tf32_common.cuh").read_text()
    assert '#include "tf32_common.cuh"' in src
    start = src.index("namespace f32 {")
    f32 = src[start:src.index("}  // namespace f32", start)]
    for used in ("matmul_stats_tf32_kernel", "tf32::mma3(p[m][n]",
                 "tf32::split(", "tf32::ldsm_x4(", "tma_load_2d(",
                 "tma_store_2d(", "mbar_wait(&full[s]", "mbar_arrive(&empty[s]",
                 "acc[m][n][e] += p[m][n][e]", "__shfl_xor_sync"):
        assert used in f32, used
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in tf32
    assert "cvt.rna.tf32.f32" in tf32
    assert "cp.async.bulk.tensor.2d.shared::cluster.global" in common
    assert "cp.async.bulk.tensor.2d.global.shared::cta" in common
    for gone in ("fmaf(", "matmul_stats_f32_kernel", "stage_f32",
                 "atomicAdd"):
        assert gone not in src, gone


def test_partial_rows_match_the_persistent_grid(monkeypatch):
    """Both dtypes run one block an SM: the wrapper hands the kernel the
    SM count of partial rows, whatever M, and the f32 launcher takes its
    rows by the bf16 route's rule (at most SM count / n-tiles, at most the
    m-tiles), which never exceeds it."""
    monkeypatch.setitem(tfused._SM_COUNT, 0, 132)
    dev = torch.device("cuda", 0)
    assert tfused._partial_rows(dev) == 132
    src, _common = _k5_source()
    launcher = src[src.index("int launch_tf32("):src.index("int launch_f32(")]
    assert "bf16_rows(args.M, args.N, BN)" in launcher
    assert "if (rows > part_rows) return (int)cudaErrorInvalidValue;" \
        in launcher
    for m, k, n in chip_smoke.K5_F32_SHAPES + chip_smoke.K5_ODD_SHAPES:
        bn = 64 if n <= 64 else 128
        n_tiles, m_tiles = -(-n // bn), -(-m // 128)
        rows = max(1, min(132 // n_tiles, m_tiles))
        assert rows * n_tiles <= 132 and rows <= tfused._partial_rows(dev)


def test_chip_smoke_f32_k5_bound_is_the_split_tf32_route():
    """f32 K5 runs 3 TF32 products a product: its bound is 3 x flops at
    495 TFLOP/s or the bytes, with the CUDA-core bound beside it."""
    m, k, n = 25088, 1024, 256
    b = chip_smoke.k5_bound(m, k, n, torch.float32)
    flops = 2.0 * m * n * k
    nbytes = 4.0 * (m * k + n * k + m * n) + 4.0 * 3 * n
    assert b["bound_ms"] == max(3 * flops / 495e12, nbytes / 3.35e12) * 1e3
    assert b["bound_by"] == "operations"
    assert b["bound_split_tf32_ms"] == b["bound_ms"]
    assert b["bound_cuda_core_ms"] == max(flops / 67e12,
                                          nbytes / 3.35e12) * 1e3
    small = chip_smoke.k5_bound(401408, 64, 64, torch.float32)
    assert small["bound_by"] == "bytes"
    assert "bound_cuda_core_ms" not in chip_smoke.k5_bound(
        m, k, n, torch.bfloat16)


def test_k5_ptxas_summary_reads_each_instantiation():
    """chip_smoke's report of -Xptxas -v for matmul_stats.cu: registers,
    shared memory and spills per kernel instantiation."""
    log = (
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__eb3707b4"
        "_15_matmul_stats_cu_e4eabcdd24matmul_stats_sm90_kernelILi256ELb0EEE"
        "v14CUtensorMap_stS1_S1_NS_4ArgsE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN48_GLOBAL__N__eb3707b4_15"
        "_matmul_stats_cu_e4eabcdd24matmul_stats_sm90_kernelILi256ELb0EEEv14"
        "CUtensorMap_stS1_S1_NS_4ArgsE\n"
        "    40 bytes stack frame, 96 bytes spill stores, 88 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 16 barriers, 1072 bytes "
        "smem\n"
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__eb3707b4"
        "_15_matmul_stats_cu_e4eabcdd3f3219stats_reduce_kernelEPKfS2_iiPfS3_'"
        " for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers, 4224 bytes smem"
        "\n")
    out = chip_smoke.k5_ptxas_summary(log)
    assert out == {
        "matmul_stats_sm90_kernel<256,0>": {
            "stack": 40, "spill_stores": 96, "spill_loads": 88,
            "registers": 168, "smem": 1072},
        "stats_reduce_kernel": {
            "stack": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 32, "smem": 4224}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1000, 72, 200), (4096, 256, 64),
                                   (300, 30, 70)], ids=str)
def test_two_launches_are_bit_identical_on_card(cuda_device, shape, dtype):
    """Every column sum has one fixed order: no atomics, a static list of
    items, the partial rows summed in order."""
    dt = getattr(torch, dtype)
    x, w, c = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(*shape))
    x, w = x.to(dt), w.to(dt)
    first = tfused.matmul_stats(x, w, c)
    second = tfused.matmul_stats(x, w, c)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 30, 70), (1000, 72, 200)],
                         ids=str)
def test_bf16_shapes_tma_refuses_are_padded_on_card(cuda_device, shape):
    m, k, n = shape
    x, w, c = (torch.from_numpy(a).to(cuda_device) for a in _inputs(*shape))
    tfused.matmul_stats.launches = 0
    tfused.matmul_stats.padded = 0
    y, s1, _s2 = tfused.matmul_stats(x.bfloat16(), w.bfloat16(), c)
    torch.cuda.synchronize()
    assert y.shape == (m, n) and y.is_contiguous() and s1.shape == (n,)
    assert tfused.matmul_stats.launches == 1
    assert tfused.matmul_stats.padded == (1 if k % 8 or n % 8 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", [False, True])
def test_f32_long_sum_keeps_f32_accuracy_on_card(cuda_device, prologue):
    """K = 2048, the longest ResNet-50 depth: the tensor cores' truncating
    accumulator would drift past 1e-5 of max |y| over such a sum; the
    split-TF32 route sums each stage apart and adds it rounded to nearest,
    and holds y to 1e-5 of max |plain| and the sums to 1e-4 by norm."""
    m, k, n = 2048, 2048, 512
    x, w, c = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(m, k, n, seed=3))
    if prologue:
        scale = torch.rand(k, device=cuda_device) + 0.5
        shift = torch.randn(k, device=cuda_device)
        got = tfused.matmul_stats_prologue(x, w, scale, shift)
        want = tfused.matmul_stats_prologue_plain(x, w, scale, shift)
    else:
        got = tfused.matmul_stats(x, w, c)
        want = tfused.matmul_stats_plain(x, w, c)
    torch.cuda.synchronize()
    (y, s1, s2), (ry, rs1, rs2) = got, want
    assert (y - ry).abs().max().item() <= 1e-5 * ry.abs().max().item()
    for s, r in ((s1, rs1), (s2, rs2)):
        assert (s - r).norm().item() <= 1e-4 * r.norm().item()
