"""The f32 route of the port's flash attention: the split-TF32 (3xTF32)
kernels ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``,
the one-pass delta kernel ``csrc/flash_attention_delta.cu``, and the rule
of what the kernels take (``kernel_takes``), which the op's gate shares.

The kernels run only on the card.  Here a model of their arithmetic,
written in plain PyTorch (each operand split as hi = tf32(x) rounded to
nearest and lo = x - hi, of which the mma reads the TF32 part, truncated;
each product as lo hi + hi lo + hi hi in f32), is held against the JAX package's Pallas forward and backward in
interpret mode on the same numpy-seeded f32 inputs, at the f32 tolerances
``chip_smoke.py`` holds the kernels to; the same model with one TF32
product (hi hi alone) must miss them.  So the CPU shows that the design
can meet the tolerances, and that they tell it from single TF32, before any
card does.
"""
import math
import re
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch import cuda_build
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.ops.registry import OpContext, get_op

# chip_smoke.py's f32 tolerances: o and lse by max |error|; each gradient
# by max |error| <= TOL_BWD_MAX max |reference| + 1e-5 and by relative norm
TOL_F32 = 1e-4
TOL_BWD_MAX = 1e-4
TOL_BWD_NORM = 1e-5


def _arrays(n, B=2, T=256, H=2, D=64, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(0, 1, (B, T, H, D))
                             .astype(np.float32)) for _ in range(n)]


def tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds; kept in an f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncated(x):
    """x as an mma reads a TF32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def product(spec, a, b, split):
    """einsum(spec, a, b) as the kernels take it: with ``split`` three
    TF32 products (lo hi + hi lo, then hi hi) summed in f32, else one."""
    ah, bh = tf32(a), tf32(b)
    if not split:
        return torch.einsum(spec, ah, bh)
    al, bl = tf32_truncated(a - ah), tf32_truncated(b - bh)
    return (torch.einsum(spec, al, bh) + torch.einsum(spec, ah, bl)) \
        + torch.einsum(spec, ah, bh)


def _mask(s, causal):
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(),
                          float("-inf"))
    return s


def model_fwd(q, k, v, causal, split=True):
    b, t, h, d = q.shape
    s = _mask(product("bqhd,bkhd->bhqk", q, k, split), causal) \
        / math.sqrt(d)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = product("bhqk,bkhd->bhqd", p, v, split) / l
    lse = (m + torch.log(l)).reshape(b * h, t, 1)
    return o.permute(0, 2, 1, 3), lse


def model_bwd(q, k, v, o, lse, do, causal, split=True):
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    s = _mask(product("bqhd,bkhd->bhqk", q, k, split), causal) * scale
    p = torch.exp(s - lse.reshape(b, h, t, 1))
    delta = tfa.flash_attention_delta_plain(o, do).reshape(b, h, t, 1)
    dv = product("bhqk,bqhd->bkhd", p, do, split)
    dp = product("bqhd,bkhd->bhqk", do, v, split)
    ds = p * (dp - delta) * scale
    dq = product("bhqk,bkhd->bqhd", ds, k, split)
    dk = product("bhqk,bqhd->bkhd", ds, q, split)
    return dq, dk, dv


def _fwd_errors(q, k, v, causal, split):
    o, lse = model_fwd(q, k, v, causal, split)
    o_j, lse_j = pk._flash_attention_fwd_pallas(
        q.numpy(), k.numpy(), v.numpy(), causal, interpret=True)
    return (np.abs(o.numpy() - np.asarray(o_j)).max(),
            np.abs(lse.numpy() - np.asarray(lse_j)).max())


def _bwd_errors(q, k, v, do, causal, split):
    """(max error over the tolerance, relative norm) of each gradient of
    the model against the Pallas backward, from the Pallas forward's o and
    lse."""
    o, lse = pk._flash_attention_fwd_pallas(q.numpy(), k.numpy(), v.numpy(),
                                            causal, interpret=True)
    o, lse = (torch.from_numpy(np.array(x)) for x in (o, lse))
    got = model_bwd(q, k, v, o, lse, do, causal, split)
    want = pk._flash_attention_bwd_pallas(
        q.numpy(), k.numpy(), v.numpy(), o.numpy(), lse.numpy(), do.numpy(),
        causal, interpret=True)
    out = []
    for x, r in zip(got, want):
        x, r = x.numpy(), np.asarray(r)
        tol = TOL_BWD_MAX * np.abs(r).max() + 1e-5
        out.append((np.abs(x - r).max() / tol,
                    np.linalg.norm(x - r) / np.linalg.norm(r)))
    return out


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_split_tf32_model_meets_f32_tolerances(D, causal):
    q, k, v, do = _arrays(4, D=D, seed=D + causal)
    err_o, err_lse = _fwd_errors(q, k, v, causal, split=True)
    assert err_o <= TOL_F32, err_o
    assert err_lse <= TOL_F32, err_lse
    for over, rel in _bwd_errors(q, k, v, do, causal, split=True):
        assert over <= 1.0 and rel <= TOL_BWD_NORM, (over, rel)


@pytest.mark.parametrize("causal", [False, True])
def test_single_tf32_model_misses_f32_tolerances(causal):
    """One TF32 product, as ``allow_tf32`` gives cuBLAS, misses every f32
    tolerance: they tell the split from it."""
    q, k, v, do = _arrays(4, D=64, seed=7)
    err_o, err_lse = _fwd_errors(q, k, v, causal, split=False)
    assert err_o > TOL_F32 and err_lse > TOL_F32, (err_o, err_lse)
    for over, rel in _bwd_errors(q, k, v, do, causal, split=False):
        assert over > 1.0 and rel > TOL_BWD_NORM, (over, rel)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10          # a TF32 value: kept
    half = 1.0 + 2.0 ** -11         # halfway up: rounds away from zero
    x = torch.tensor([one, half, -half, 1.0 + 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    want = [one, one, -one, 1.0, 3.0]
    assert tf32(x).tolist() == want
    hi = tf32(x)
    assert torch.equal(hi + tf32_truncated(x - hi), x)   # exact here


# ------------------------------------------------------------------ delta
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_delta_plain_matches_jax_expression(dtype):
    """``flash_attention_delta_plain`` against the TPU code's jnp delta
    (``_flash_attention_bwd_pallas``: rowsum of the f32 product of the
    folded dO and O, keepdims)."""
    import jax.numpy as jnp
    o, do = (x.to(getattr(torch, dtype)) for x in
             _arrays(2, B=2, T=64, H=3, D=32, seed=11))
    fold = pk._fold_heads
    if dtype == "float32":
        oj, doj = o.numpy(), do.numpy()
    else:
        oj, doj = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                   for x in (o, do))
    want = jnp.sum(fold(doj).astype(jnp.float32)
                   * fold(oj).astype(jnp.float32), axis=-1, keepdims=True)
    got = tfa.flash_attention_delta_plain(o, do)
    assert got.shape == (6, 64, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), 1e-6, 1e-6)


def test_delta_cpu_tensor_takes_the_plain_version():
    o, do = _arrays(2, B=1, T=32, H=2, D=64, seed=12)
    before = tfa.flash_attention_delta.launches
    got = tfa.flash_attention_delta(o, do)
    assert tfa.flash_attention_delta.launches == before
    assert torch.equal(got, tfa.flash_attention_delta_plain(o, do))


def test_bwd_plain_takes_the_plain_delta(monkeypatch):
    """The backward's plain version reads delta from
    ``flash_attention_delta_plain``, the expression the kernel is held to."""
    q, k, v, do = _arrays(4, B=1, T=32, H=2, D=32, seed=13)
    o, lse = tfa.flash_attention_plain(q, k, v, True)
    seen = []
    real = tfa.flash_attention_delta_plain

    def spy(o_, do_):
        seen.append(1)
        return real(o_, do_)

    monkeypatch.setattr(tfa, "flash_attention_delta_plain", spy)
    tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    assert seen == [1]


# ------------------------------------------------------- what the kernels take
def _case(kind):
    """(q, k, v) for one case of the routing rule, and whether the kernels
    take it."""
    def full(shape=(1, 128, 2, 64), dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    if kind == "f32":
        x = full()
        return (x, x, x), True
    if kind == "bf16":
        x = full(dtype=torch.bfloat16)
        return (x, x, x), True
    if kind == "qkv_views":
        # the GPT's q, k, v: views into one (B, T, 3, H, D) tensor
        qkv = torch.zeros(2, 128, 3, 2, 32)
        return tuple(qkv.narrow(2, i, 1).reshape(2, 128, 2, 32)
                     for i in range(3)), True
    if kind == "d96":
        x = full((1, 128, 2, 96))
        return (x, x, x), False
    if kind == "f16":
        x = full(dtype=torch.float16)
        return (x, x, x), False
    if kind == "f64":
        x = full(dtype=torch.float64)
        return (x, x, x), False
    if kind == "bh_over_65535":
        x = full((1, 1, 65536, 32))
        return (x, x, x), False
    if kind == "f32_base":
        # one element (4 bytes) past a 16-byte boundary
        flat = torch.zeros(128 * 2 * 64 + 4)
        k = flat[1:1 + 128 * 2 * 64].view(1, 128, 2, 64)
        x = full()
        return (x, k, x), False
    if kind == "f32_seq_stride":
        # rows of H*D + 2 values: 8-byte strides
        wide = torch.zeros(1, 128, 2 * 64 + 2)
        x = full()
        return (x, x, wide[..., :128].reshape(1, 128, 2, 64)), False
    if kind == "bf16_head_stride":
        wide = torch.zeros(1, 128, 2, 64 + 4, dtype=torch.bfloat16)
        x = full(dtype=torch.bfloat16)
        return (wide[..., :64], x, x), False
    raise AssertionError(kind)


CASES = ["f32", "bf16", "qkv_views", "d96", "f16", "f64", "bh_over_65535",
         "f32_base", "f32_seq_stride", "bf16_head_stride"]


@pytest.mark.parametrize("kind", CASES)
def test_kernel_takes_and_check_kernel_args_agree(kind):
    (q, k, v), takes = _case(kind)
    why = tfa.kernel_takes(q, k, v)
    assert (why is None) == takes, why
    if takes:
        tfa.check_kernel_args(q, k, v)
    else:
        with pytest.raises(MXNetError, match=re.escape(why)):
            tfa.check_kernel_args(q, k, v)


@pytest.mark.parametrize("kind", CASES)
def test_op_routes_what_the_kernels_do_not_take_to_attention_plain(
        kind, monkeypatch):
    """The op's gate reads the same rule: inputs the kernels take go
    through ``FlashAttention``, the rest through ``attention_plain``, as
    the JAX op sends them to ``_attention_jnp``."""
    (q, k, v), takes = _case(kind)
    rng = np.random.RandomState(CASES.index(kind))
    for x in {id(t): t for t in (q, k, v)}.values():
        x.copy_(torch.from_numpy(rng.normal(0, 1, x.shape)
                                 .astype(np.float32)).to(x.dtype))
    taken = []
    real_apply = tfa.FlashAttention.apply
    monkeypatch.setattr(tfa.FlashAttention, "apply",
                        lambda *a: taken.append("flash") or real_apply(*a))
    op = get_op("_contrib_FlashAttention")
    got = op.fcompute(op.parse_attrs({"causal": "True"}), OpContext(),
                      q, k, v)
    assert taken == (["flash"] if takes else [])
    want = tfa.attention_plain(q, k, v, True)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = {torch.bfloat16: 2e-2, torch.float16: 2e-3}.get(q.dtype, 1e-5)
    assert (got.float() - want.float()).abs().max().item() <= tol


# ----------------------------------------------------------------- sources
def _with_headers(path):
    """A source's text with the text of the local headers it includes."""
    text = path.read_text()
    for line in text.splitlines():
        if line.startswith('#include "'):
            text += _with_headers(path.parent / line.split('"')[1])
    return text


def test_f32_routes_run_split_tf32_on_the_tensor_cores():
    csrc = Path(cuda_build.__file__).parent
    for routes in (tfa._FWD_ROUTES, tfa._BWD_ROUTES):
        name, entry, _ = routes[torch.float32]
        src = csrc / cuda_build.SOURCES[name]
        text = _with_headers(src)
        assert entry in src.read_text() and 'extern "C"' in text
        assert "mma.sync.aligned.m16n8k8" in text and ".tf32" in text
        assert "cvt.rna.tf32.f32" in text
        assert "cp.async.bulk.tensor" in text and "mbarrier" in text
        assert "cublas" not in text.lower() and "cudnn" not in text.lower()
        # one route a dtype: no CUDA-core f32 copy of the products
        assert "fmaf(qv" not in text and "fmaf(pv" not in text


def test_delta_kernel_is_registered():
    csrc = Path(cuda_build.__file__).parent
    assert cuda_build.SOURCES["flash_attention_delta"] == \
        "csrc/flash_attention_delta.cu"
    text = (csrc / cuda_build.SOURCES["flash_attention_delta"]).read_text()
    assert tfa._DELTA_ROUTE[1] in text and tfa._DELTA_ROUTE[2] in text
    assert "atomic" not in text


# ------------------------------------------------------------- chip_smoke
def test_chip_smoke_f32_bound_is_the_split_tf32_route():
    """The f32 bound is 3 x flops at the TF32 peak, with the CUDA-core bound
    beside it; the bf16 bound is unchanged."""
    import chip_smoke
    f32 = chip_smoke.attention_bound(4, 1024, 16, 64, torch.float32, True)
    assert f32["bound_by"] == "operations" and "split TF32" in f32["peak"]
    assert f32["bound_ms"] == pytest.approx(3 * f32["flops"] / 495e12 * 1e3)
    assert f32["bound_cuda_core_ms"] == pytest.approx(
        f32["flops"] / 67e12 * 1e3)
    assert f32["bound_ms"] == pytest.approx(0.0521, abs=1e-4)
    bf16 = chip_smoke.attention_bound(4, 1024, 16, 64, torch.bfloat16, True)
    assert "bound_cuda_core_ms" not in bf16
    assert bf16["bound_ms"] == pytest.approx(
        max(bf16["flops"] / 989e12, bf16["bytes"] / 3.35e12) * 1e3)


def test_chip_smoke_reads_the_ptxas_report():
    import chip_smoke
    text = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114flash_"
        "fwd_tf32ILi64EEEv14CUtensorMap_stS1_S1_NS_6ParamsE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_114flash_"
        "fwd_tf32ILi64EEEv14CUtensorMap_stS1_S1_NS_6ParamsE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 217 registers, used 1 barriers, 48 bytes smem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118flash_"
        "delta_kernelI13__nv_bfloat16Li32EEEvPKT_S4_Pfxii' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 26 registers, used 0 barriers"])
    assert chip_smoke.ptxas_summary(text) == {
        "flash_fwd_tf32<64>": {"stack": 0, "spill_stores": 0,
                               "spill_loads": 0, "registers": 217,
                               "smem": 48},
        "flash_delta_kernel<32,bf16>": {"stack": 8, "spill_stores": 4,
                                        "spill_loads": 4, "registers": 26,
                                        "smem": 0}}


def test_chip_smoke_flash_cases_cover_both_dtypes():
    import chip_smoke
    cases = {c[:4] + (c[5],) for c in chip_smoke.FLASH_CASES
             if c[4] == torch.float32}
    for shape in [(16, 1024, 16, 64, True),
                  (4, 1024, 16, 64, True), (4, 1024, 16, 64, False),
                  (1, 4096, 16, 64, True), (4, 1024, 8, 32, True),
                  (4, 1024, 8, 128, True), (2, 1000, 4, 64, True),
                  (2, 1000, 4, 64, False), (3, 257, 5, 64, True)]:
        assert shape in cases
        assert shape[:4] + (torch.bfloat16, shape[4]) in \
            chip_smoke.FLASH_CASES


# ------------------------------------------------------ the design experiment
@pytest.mark.parametrize("variant", ["round_lo", "accumulate", "tile64",
                                     "tile16"])
def test_experiment_variants_edit_the_committed_sources(variant):
    """Each variant of ``tools.flash_f32_experiment`` undoes a choice that
    the committed sources still make: every text it replaces is there."""
    from mxnet_tpu_torch.tools import flash_f32_experiment as exp
    csrc = Path(cuda_build.__file__).parent / "csrc"
    for name, edits in exp.VARIANTS[variant].items():
        text = (csrc / name).read_text()
        for old, new in edits:
            assert old in text and new not in text


def test_experiment_needs_a_card(monkeypatch):
    from mxnet_tpu_torch.tools import flash_f32_experiment as exp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        exp.main([])
