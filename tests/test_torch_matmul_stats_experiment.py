"""K7 and K8, the matmul_stats experiment: the port's plain versions against
the JAX tool's Pallas kernels (``tools/pallas_matmul_stats_experiment.py``,
loaded by path) run under ``force_tpu_interpret_mode``, on the same bf16
inputs from a seed.

Tolerances: y within one bf16 ulp of the JAX y (both round an f32
accumulator of exact bf16 products once; the accumulators differ only in
the order of their f32 sums); the (1, N) statistics by relative norm 1e-5
(f32 sums of 1024 rows in other orders).  The ``cuda`` tests hold the CUDA
kernels against the plain versions on the card.  K8 through the bf16
padding rule (``ops.fused.pad_operands``) is held to the JAX tool at the
unpadded shape, and to the unpadded plain version (y exactly, the sums by
relative norm 1e-6: the same f32 terms summed over a wider tensor).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused
from mxnet_tpu_torch.tools import matmul_stats_experiment as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    path = os.path.join(ROOT, "tools", "pallas_matmul_stats_experiment.py")
    spec = importlib.util.spec_from_file_location("_pallas_mse", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JTOOL = _jax_tool()

# (M, K, N): M a multiple of the JAX tool's 512-row blocks
SHAPES = [(1024, 64, 128), (512, 256, 64)]


def _inputs(m, k, n, seed=0):
    """bf16 x and w and f32 scale and shift, drawn as the JAX tool draws
    them; returned for JAX and, from the same values, for the port."""
    rng = np.random.RandomState(seed)
    jx = jnp.asarray(rng.randn(m, k), jnp.bfloat16)
    jw = jnp.asarray(rng.randn(k, n) * 0.05, jnp.bfloat16)
    jscale = jnp.asarray(rng.rand(1, k), jnp.float32)
    jshift = jnp.asarray(rng.randn(1, k), jnp.float32)
    t = [torch.from_numpy(np.array(a.astype(jnp.float32)))
         for a in (jx, jw, jscale, jshift)]
    return (jx, jw, jscale, jshift), \
        (t[0].bfloat16(), t[1].bfloat16(), t[2], t[3])


def _check(got, want):
    (y, s, ss), (wy, ws, wss) = [[np.asarray(v, np.float32) for v in o]
                                 for o in (got, want)]
    assert y.shape == wy.shape and s.shape == ws.shape == ss.shape
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(wy), 1e-30))) - 7)
    assert (np.abs(y - wy) <= ulp).all()
    for a, b in ((s, ws), (ss, wss)):
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)


def _np(out):
    return [v.float().numpy() for v in out]


def _jnp(out):
    return [np.asarray(v.astype(jnp.float32)) for v in out]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k7_plain_matches_the_pallas_kernel(shape):
    (jx, jw, _s, _b), (x, w, _ts, _tb) = _inputs(*shape)
    with pltpu.force_tpu_interpret_mode():
        want = JTOOL.matmul_stats(jx, jw)
    before = fused.matmul_stats.launches
    got = tool.matmul_stats(x, w)
    assert fused.matmul_stats.launches == before   # the CPU takes plain
    assert got[0].dtype == torch.bfloat16 and got[1].shape == (1, shape[2])
    _check(_np(got), _jnp(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k8_plain_matches_the_pallas_kernel(shape):
    (jx, jw, js, jb), (x, w, scale, shift) = _inputs(*shape)
    with pltpu.force_tpu_interpret_mode():
        want = JTOOL.matmul_stats_prologue(jx, jw, js, jb)
    before = fused.matmul_stats_prologue.launches
    got = tool.matmul_stats_prologue(x, w, scale, shift)
    assert fused.matmul_stats_prologue.launches == before
    _check(_np(got), _jnp(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_library_yardsticks_match_the_xla_ones(shape):
    """``library_ref`` and ``library_dot_only`` against ``xla_ref`` and
    ``xla_dot_only``: y within one bf16 ulp, the sums of the rounded y by
    relative norm 1e-5."""
    (jx, jw, _s, _b), (x, w, _ts, _tb) = _inputs(*shape)
    _check(_np(tool.library_ref(x, w)), _jnp(JTOOL.xla_ref(jx, jw)))
    y = tool.library_dot_only(x, w).float().numpy()
    wy = np.asarray(JTOOL.xla_dot_only(jx, jw).astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(wy), 1e-30))) - 7)
    assert (np.abs(y - wy) <= ulp).all()


def test_k7_is_k5_with_c_zero():
    _j, (x, w, _s, _b) = _inputs(300, 72, 40)
    y, s, ss = tool.matmul_stats(x, w)
    ry, rs, rss = fused.matmul_stats_plain(x, w, torch.zeros(40))
    assert torch.equal(y, ry) and torch.equal(s[0], rs) \
        and torch.equal(ss[0], rss)


def test_k8_prologue_rounds_before_the_product():
    """K8 is K7 of bf16(relu(x * scale + shift)), and the rounding shows:
    the product of the unrounded f32 prologue differs."""
    _j, (x, w, scale, shift) = _inputs(512, 64, 128)
    xh = torch.relu(x.float() * scale + shift)
    got = tool.matmul_stats_prologue(x, w, scale, shift)
    want = tool.matmul_stats(xh.bfloat16(), w)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    unrounded = (xh @ w.float()).sum(0)
    assert not torch.allclose(got[1][0], unrounded, rtol=1e-6, atol=0)


def test_prologue_wrapper_refuses_mismatched_inputs():
    """The CUDA path checks its inputs before it builds anything."""
    x, w, c = torch.zeros(8, 4), torch.zeros(4, 3), torch.zeros(3)
    with pytest.raises(MXNetError, match="scale must be float32 with 4"):
        fused._launch(x, w, c, torch.zeros(3), torch.zeros(4))
    with pytest.raises(MXNetError, match="shift must be float32"):
        fused._launch(x, w, c, torch.zeros(4), torch.zeros(4).double())


def test_experiment_runs_on_the_cpu_at_a_small_batch(monkeypatch):
    """The tool's own loop (its check of K7 against the library, its
    timings) at two small shapes; on the CPU every call is plain."""
    monkeypatch.setattr(tool, "shapes",
                        lambda batch: [(batch * 64, 64, 128),
                                       (batch * 8, 72, 40)])
    rows = tool.experiment(batch=2, repeats=1, chain=2, device="cpu")
    assert [(r["M"], r["K"], r["N"]) for r in rows] == \
        [(128, 64, 128), (16, 72, 40)]
    for r in rows:
        for key in ("dot_ms", "library_ms", "kernel_ms", "prologue_ms",
                    "library_prologue_ms"):
            assert r[key] > 0


def test_shapes_are_the_jax_tools():
    assert tool.shapes(128)[0] == (128 * 56 * 56, 64, 256)
    assert len(tool.shapes(128)) == 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1000, 72, 200), (300, 30, 70),
                                   (4096, 256, 64)], ids=str)
def test_k8_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    """Ragged M and N, K not a multiple of the tile depth, and (K = 30) the
    unvectorized loads: depth columns past K must add nothing, rows past
    M must not enter the statistics."""
    dt = getattr(torch, dtype)
    _j, (x, w, scale, shift) = _inputs(*shape)
    x, w = x.to(cuda_device, dt), w.to(cuda_device, dt)
    scale, shift = scale.to(cuda_device), shift.to(cuda_device)
    before = fused.matmul_stats_prologue.launches
    y, s1, s2 = fused.matmul_stats_prologue(x, w, scale, shift)
    torch.cuda.synchronize()
    assert fused.matmul_stats_prologue.launches == before + 1
    ry, rs1, rs2 = fused.matmul_stats_prologue_plain(x, w, scale, shift)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert (y.float() - ry.float()).abs().max().item() \
        <= tol * ry.float().abs().max().item()
    for s, r in ((s1, rs1), (s2, rs2)):
        assert (s - r).norm().item() <= 1e-4 * r.norm().item()


@pytest.mark.parametrize("shape", [(512, 30, 70), (1024, 64, 100)], ids=str)
def test_k8_padding_keeps_the_function(shape):
    (jx, jw, js, jb), (x, w, scale, shift) = _inputs(*shape)
    n = shape[2]
    xp, wp, c, sp, bp = fused.pad_operands(x, w, None, scale, shift)
    assert c is None and sp.shape == bp.shape == (xp.shape[1],)
    y, s, ss = fused.matmul_stats_prologue_plain(x, w, scale, shift)
    yp, sp_, ssp = fused.matmul_stats_prologue_plain(xp, wp, sp, bp)
    assert torch.equal(yp[:, :n], y) and not yp[:, n:].float().any()
    for got, want in ((sp_, s), (ssp, ss)):
        assert not got[n:].any()
        assert (got[:n] - want).norm() <= 1e-6 * want.norm()
    with pltpu.force_tpu_interpret_mode():
        want = JTOOL.matmul_stats_prologue(jx, jw, js, jb)
    _check([yp[:, :n].float().numpy(), sp_[:n].numpy().reshape(1, -1),
            ssp[:n].numpy().reshape(1, -1)], _jnp(want))


def test_k7_zero_vector_is_made_once():
    """K7's c = 0 is cached per width and device, not allocated a call."""
    _j, (x, w, _s, _b) = _inputs(512, 64, 128)
    assert tool._zeros(128, x.device) is tool._zeros(128, x.device)
    assert not tool._zeros(128, x.device).any()
    assert tool._zeros(64, x.device).shape == (64,)


def test_k5_shapes_are_the_resnet_steps():
    """The tool's K5 shapes are chip_smoke's, the 16 launches of one
    ResNet-50 step."""
    assert tool.k5_shapes(128) == [(m, k, n) for m, k, n, _c
                                   in chip_smoke.K5_BENCH_SHAPES]


@pytest.mark.parametrize("variant", sorted(tool.VARIANTS))
def test_every_variant_finds_its_text(variant):
    """Each variant is a text edit of the committed source and must find
    what it replaces; it changes matmul_stats.cu and nothing else."""
    texts = tool._sources(variant, None)
    committed = (tool._CSRC / "matmul_stats.cu").read_text()
    assert texts["matmul_stats.cu"] != committed
    assert texts["sm90_common.cuh"] == \
        (tool._CSRC / "sm90_common.cuh").read_text()


def test_generated_register_a_product_numbers_its_operands():
    """The m64n256k16 register-A wgmma of the pro_registers variant: 128
    accumulators, then the 4 A registers, the descriptor, scale-d and the
    transpose bit, in the order sm90_common.cuh's forms use."""
    src = tool._wgmma_rs(256)
    assert "m64n256k16" in src and "float (&d)[128]" in src
    assert "setp.ne.b32 p, %133, 0;" in src
    assert "{%128, %129, %130, %131}, %132, p, 1, 1, %134;" in src
    assert src.count('"+f"(d[') == 128
