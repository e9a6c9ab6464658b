"""The bf16 route of the port's flash attention: the tensor-core kernels
``csrc/flash_attention_fwd_sm90.cu`` and ``csrc/flash_attention_bwd_sm90.cu``.

The kernels run only on the card.  Here a rounding model of them, written
in plain PyTorch (f32 accumulation; the forward's online softmax over its key
tiles; P, P^T and dS rounded to bf16 before the products that read them;
outputs rounded to bf16), is held against the JAX package's Pallas forward
and backward in interpret mode on the same numpy-seeded bf16 inputs, at the
tolerances ``chip_smoke.py`` holds the kernels to.  So the CPU shows that
the design can meet them before any card does.  The bf16 route's argument
checks (TMA alignment, head dims) are tested too.
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
from mxnet_tpu_torch.tools import flash_bf16_fwd_experiment as fwd_experiment

# chip_smoke.py's bf16 tolerances: o by max |error|, lse by max |error|,
# each gradient by max |error| against max |reference| and by relative norm
TOL_BF16 = 2e-2
TOL_LSE = 1e-4
TOL_BWD_MAX = 2e-2
TOL_BWD_NORM = 1e-2
LOG2E = 1.0 / math.log(2.0)


def key_tile(d):
    """Keys per K/V tile of the forward kernel (``Cfg<D>::BN``)."""
    return 64 if d == 128 else 128


def _source_key_tile(d):
    """``Cfg<D>::BN`` as ``csrc/flash_attention_fwd_sm90.cu`` states it,
    a constant or a C conditional on D, evaluated at ``d``."""
    src = Path(cuda_build.__file__).parent / cuda_build.SOURCES[
        "flash_attention_fwd_sm90"]
    expr = re.search(r"static constexpr int BN = ([^;]+);",
                     src.read_text()).group(1)
    cond = re.fullmatch(r"(.+?)\?(.+?):(.+)", expr)
    if cond:
        expr = "(%s) if (%s) else (%s)" % (cond.group(2), cond.group(1),
                                           cond.group(3))
    return eval(expr, {"D": d})


def _bf16_arrays(n, B=2, T=256, H=2, D=64, seed=0):
    """``n`` (B, T, H, D) arrays from a seed, rounded to bf16 and held as
    f32 (the values the kernels read)."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(0, 1, (B, T, H, D))
                             .astype(np.float32)).bfloat16()
            for _ in range(n)]


def _scores(q, k, causal, scale):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t = q.shape[1]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(),
                          float("-inf"))
    return s


def model_fwd(q, k, v, causal):
    """The forward kernel's arithmetic: scores in log2 units, a running max
    and sum over its key tiles, P rounded to bf16 for P V, o / l in bf16
    and lse = m ln 2 + log l."""
    b, t, h, d = q.shape
    s = _scores(q, k, causal, LOG2E / math.sqrt(d))
    vf = v.float()
    m = torch.full((b, h, t), float("-inf"))
    l = torch.zeros(b, h, t)
    o = torch.zeros(b, h, t, d)
    tile = key_tile(d)
    for k0 in range(0, t, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1))
        base = torch.where(m_new == float("-inf"), torch.zeros(()), m_new)
        corr = torch.exp2(m - base)
        p = torch.exp2(st - base.unsqueeze(-1))
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(),
                          vf[:, k0:k0 + tile])
        o = o * corr.unsqueeze(-1) + pv
        m = m_new
    out = (o / l.unsqueeze(-1)).permute(0, 2, 1, 3).bfloat16()
    lse = (m * math.log(2.0) + torch.log(l)).reshape(b * h, t, 1)
    return out, lse


def model_bwd(q, k, v, o, lse, do, causal):
    """The backward kernels' arithmetic: P = exp2(S scale log2e - lse
    log2e) in f32, dP and delta in f32, P and dS rounded to bf16 before
    the products that read them, the gradients summed in f32 and rounded
    to bf16."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    s = _scores(q, k, causal, scale * LOG2E)
    p = torch.exp2(s - lse.reshape(b, h, t, 1) * LOG2E)
    dof = do.float()
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1).unsqueeze(-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = (p * (dp - delta) * scale).bfloat16().float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return tuple(x.bfloat16() for x in (dq, dk, dv))


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_rounding_model_meets_chip_tolerances(D, causal):
    q, k, v, do = _bf16_arrays(4, D=D, seed=D)
    qj, kj, vj, doj = (x.float().numpy() for x in (q, k, v, do))

    o, lse = model_fwd(q, k, v, causal)
    o_j, lse_j = pk._flash_attention_fwd_pallas(qj, kj, vj, causal,
                                                interpret=True)
    assert o.dtype == torch.bfloat16 and lse.shape == (2 * 2, 256, 1)
    err_o = np.abs(o.float().numpy() - np.asarray(o_j)).max()
    err_lse = np.abs(lse.numpy() - np.asarray(lse_j)).max()
    assert err_o <= TOL_BF16, err_o
    assert err_lse <= TOL_LSE, err_lse

    # the backward from the model's own o and lse, as the card runs it
    got = model_bwd(q, k, v, o, lse, do, causal)
    want = pk._flash_attention_bwd_pallas(qj, kj, vj, o.float().numpy(),
                                          lse.numpy(), doj, causal,
                                          interpret=True)
    for x, r in zip(got, want):
        x, r = x.float().numpy(), np.asarray(r)
        assert np.abs(x - r).max() <= TOL_BWD_MAX * np.abs(r).max()
        assert np.linalg.norm(x - r) / np.linalg.norm(r) <= TOL_BWD_NORM


@pytest.mark.parametrize("D", [32, 64, 128])
def test_model_key_tile_is_the_kernels(D):
    """The model streams the key tiles the kernel does: read from the
    source, so the two cannot drift apart."""
    assert key_tile(D) == _source_key_tile(D)


@pytest.mark.parametrize("variant", sorted(fwd_experiment.VARIANTS))
def test_experiment_variants_edit_the_committed_source(variant):
    """Each variant of ``tools/flash_bf16_fwd_experiment.py`` finds the
    text it replaces in the committed forward, so a variant cannot go
    stale and time the committed kernel under another name."""
    texts = fwd_experiment._sources(variant, None)
    name = Path(cuda_build.SOURCES["flash_attention_fwd_sm90"]).name
    committed = (Path(cuda_build.__file__).parent / "csrc" / name) \
        .read_text()
    assert texts[name] != committed
    assert "sm90_common.cuh" in texts


def test_sass_registers_reads_each_instantiation(monkeypatch):
    """``cuda_build.sass_registers`` gives, per ``kernel<D>``
    instantiation of a library's SASS, the highest register it names
    (R201 past the 168 the entry reports), and skips functions that are
    not such an instantiation."""
    sass = (
        "\tcode for sm_90a\n"
        "\t\tFunction : _ZN12_GLOBAL__N_121flash_fwd_sm90_kernelILi64EEEv"
        "14CUtensorMap_stS1_S1_NS_6ParamsEii\n"
        "        /*0010*/  MOV R1, c[0x0][0x28] ;\n"
        "        /*0020*/  HMMA R201, R12, R4, R201 ;\n"
        "\t\tFunction : _ZN12_GLOBAL__N_121flash_fwd_sm90_kernelILi128EEEv"
        "14CUtensorMap_stS1_S1_NS_6ParamsEii\n"
        "        /*0010*/  IADD3 R136, R2, R7, RZ ;\n"
        "\t\tFunction : helper\n"
        "        /*0010*/  MOV R250, R1 ;\n")
    monkeypatch.setattr(cuda_build, "_sass", lambda lib: sass)
    assert cuda_build.sass_registers("lib.so") == {"D=64": 201,
                                                  "D=128": 136}


@pytest.mark.parametrize("causal", [False, True])
def test_rounding_model_at_d128_and_ragged_t(causal):
    """D=128 with its 64-key tiles at T=200, which is not a multiple of
    them or of the 128 query rows of a block: full tiles and a ragged one
    (keys past T masked), against the Pallas forward in interpret mode
    with blocks that divide T."""
    q, k, v = _bf16_arrays(3, B=1, T=200, H=2, D=128, seed=11)
    o, lse = model_fwd(q, k, v, causal)
    o_j, lse_j = pk._flash_attention_fwd_pallas(
        *(x.float().numpy() for x in (q, k, v)), causal, interpret=True,
        blocks=(40, 200))
    assert o.shape == (1, 200, 2, 128) and lse.shape == (2, 200, 1)
    assert np.abs(o.float().numpy() - np.asarray(o_j)).max() <= TOL_BF16
    assert np.abs(lse.numpy() - np.asarray(lse_j)).max() <= TOL_LSE


def test_rounding_model_is_finer_than_the_tolerance_needs():
    """The model is not the f32 plain version: P rounded to bf16 moves o,
    and the tolerance still has room over that move."""
    q, k, v = _bf16_arrays(3, D=64, seed=5)
    o, _ = model_fwd(q, k, v, True)
    ro, _ = tfa.flash_attention_plain(q.float(), k.float(), v.float(), True)
    diff = (o.float() - ro).abs().max().item()
    assert 0.0 < diff <= TOL_BF16 / 2


def _bf16_qkv(B=1, T=64, H=2, D=64):
    return _bf16_arrays(3, B=B, T=T, H=H, D=D, seed=7)


def test_bf16_route_takes_aligned_views_of_one_qkv_tensor():
    """The GPT's q, k, v are views into one (B, T, 3, H, D) tensor, 16-byte
    aligned: the bf16 route takes them, and a size-1 dim's stride is not
    held to the alignment rule."""
    qkv = torch.zeros(2, 128, 3, 2, 64, dtype=torch.bfloat16)
    q, k, v = (qkv.narrow(2, i, 1).reshape(2, 128, 2, 64) for i in range(3))
    tfa.check_kernel_args(q, k, v)
    base = torch.zeros(64 * 2 * 64 + 8, dtype=torch.bfloat16)
    one = torch.as_strided(base, (1, 64, 2, 64), (7, 128, 64, 1))
    assert tfa.kernel_strides(one) == (64 * 128, 128, 64)
    tfa.check_kernel_args(one, one, one)


@pytest.mark.parametrize("bad", ["base", "seq_stride", "head_stride",
                                 "head_dim"])
def test_bf16_route_argument_checks(bad):
    q, k, v = _bf16_qkv()
    if bad == "base":
        # one element (2 bytes) past a 16-byte boundary
        flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
        k = flat[1:].view(q.shape)
    elif bad == "seq_stride":
        # rows of H*D + 4 elements: 8-byte strides
        wide = torch.zeros(1, 64, 2 * 64 + 4, dtype=torch.bfloat16)
        v = wide[..., :128].reshape(1, 64, 2, 64)
    elif bad == "head_stride":
        wide = torch.zeros(1, 64, 2, 64 + 4, dtype=torch.bfloat16)
        q = wide[..., :64]
        assert q.stride(-1) == 1
    else:
        q, k, v = (torch.zeros(1, 64, 2, 96, dtype=torch.bfloat16)
                   for _ in range(3))
    with pytest.raises(MXNetError):
        tfa.check_kernel_args(q, k, v)


def test_f32_route_keeps_taking_unaligned_strides():
    """The f32 kernels load by TMA too, so they take only 16-byte aligned
    bases and strides: the wrappers raise on an unaligned f32 stride, and
    the op still answers it, through ``attention_plain``."""
    from mxnet_tpu_torch.ops.registry import OpContext, get_op
    aligned = torch.zeros(1, 64, 2 * 64 + 4)          # 528-byte rows
    q = aligned[..., :128].reshape(1, 64, 2, 64)
    tfa.check_kernel_args(q, q, q)
    rng = np.random.RandomState(3)
    wide = torch.from_numpy(rng.normal(0, 1, (1, 64, 2 * 64 + 2))
                            .astype(np.float32))      # 520-byte rows
    q = wide[..., :128].reshape(1, 64, 2, 64)
    assert q.stride(-1) == 1
    with pytest.raises(MXNetError):
        tfa.check_kernel_args(q, q, q)
    op = get_op("_contrib_FlashAttention")
    got = op.fcompute(op.parse_attrs({"causal": "True"}), OpContext(),
                      q, q, q)
    assert torch.equal(got, tfa.attention_plain(q, q, q, True))


def test_routes_dispatch_by_dtype_to_their_sources():
    csrc = Path(cuda_build.__file__).parent
    for routes, old, new in (
            (tfa._FWD_ROUTES, "flash_attention_fwd",
             "flash_attention_fwd_sm90"),
            (tfa._BWD_ROUTES, "flash_attention_bwd",
             "flash_attention_bwd_sm90")):
        assert routes[torch.float32][0] == old
        assert routes[torch.bfloat16][0] == new
        text = (csrc / cuda_build.SOURCES[new]).read_text()
        assert "extern \"C\"" in text and routes[torch.bfloat16][1] in text
    common = (csrc / "csrc" / "sm90_common.cuh").read_text()
    assert "wgmma.mma_async" in common
    assert "cp.async.bulk.tensor" in common and "mbarrier" in common
    for name in ("flash_attention_fwd_sm90", "flash_attention_bwd_sm90"):
        text = (csrc / cuda_build.SOURCES[name]).read_text().lower()
        assert "cublas" not in text and "cudnn" not in text


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_bf16_cpu_tensor_takes_the_plain_version(which):
    q, k, v = _bf16_qkv(T=128)
    if which == "fwd":
        before = tfa.flash_attention_fwd.launches
        o, lse = tfa.flash_attention_fwd(q, k, v, True)
        assert tfa.flash_attention_fwd.launches == before
        ro, rl = tfa.flash_attention_plain(q, k, v, True)
        assert torch.equal(o, ro) and torch.equal(lse, rl)
    else:
        o, lse = tfa.flash_attention_plain(q, k, v, True)
        before = tfa.flash_attention_bwd.launches
        got = tfa.flash_attention_bwd(q, k, v, o, lse, q, True)
        assert tfa.flash_attention_bwd.launches == before
        want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, q, True)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
