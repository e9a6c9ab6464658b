"""K9, the stage-1 bottleneck block: the port's ``block_plain`` against the
JAX tool's Pallas kernel (``tools/pallas_block_experiment.py``, loaded by
path) in interpret mode, and ``library_block`` against its ``xla_block``,
on the same inputs from a seed, at batch 1: bf16 at the tests' set and
both stage-1 sets, f32 at those and at the general route's sets (24, 80,
40) and (64, 128, 256), which take bf16 too.  The JAX kernel reads its
first BatchNorm as the scales' whole first row, so it takes cin >= cmid
only; for cin < cmid it gets x and w1 padded with zero channels to cmid,
which leaves y as it is.

Tolerances, as a share of max |y|: 1e-2 in bf16.  ``block_plain`` and the
Pallas kernel both compute in f32 and round y to bf16 once, so they differ
by the rounding of a y whose f32 values differ in their last bits (one bf16
ulp, under 4e-3 of an entry); ``library_block`` and ``xla_block`` round at
the same four places.  In f32, 1e-5: both sum the same f32 products in
other orders (up to 9 x 128 terms a sum).  The router (``route``) sends
bf16 within ``kernel_takes`` to the wgmma kernel (sm90) and everything else
within ``general_takes`` to the general kernel, and refuses the rest before
it builds anything.  The ``cuda`` tests hold both CUDA kernels against
``block_plain`` on the card: bf16 at the JAX tool's limit, 5e-2, f32 at
chip_smoke's ``TOL_BLOCK_F32``.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools import block_experiment as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    path = os.path.join(ROOT, "tools", "pallas_block_experiment.py")
    spec = importlib.util.spec_from_file_location("_pallas_block", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JTOOL = _jax_tool()


def _both(cin, cmid, cout, seed=0, shifts=None, dtype=torch.bfloat16):
    """The tool's inputs at batch 1 for the port and, from the same values,
    for JAX."""
    args = list(tool.inputs(1, cin, cmid, cout, device="cpu", seed=seed,
                            dtype=dtype))
    if shifts is not None:
        args[5] = shifts
    jargs = [jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)
        for a in args]
    if cin < cmid:
        # the JAX kernel reads the first BatchNorm as the scales' whole
        # first row, so it takes scales exactly cin wide and cin >= cmid:
        # it gets x and w1 padded with zero channels to cmid, which leaves
        # y as it is (a zero channel meets a zero row of w1)
        jargs[0] = jnp.pad(jargs[0], ((0, 0),) * 3 + ((0, cmid - cin),))
        jargs[1] = jnp.pad(jargs[1], ((0, cmid - cin), (0, 0)))
    return args, jargs


def _rel(y, want):
    want = np.asarray(want.astype(jnp.float32))
    return np.abs(y.float().numpy() - want).max() / np.abs(want).max()


#: the tests' small set and both stage-1 sets of a deep ResNet
CHANNELS = [(16, 16, 32), (64, 64, 256), (256, 64, 256)]


@pytest.mark.parametrize("channels", CHANNELS, ids=str)
def test_plain_matches_the_pallas_kernel(channels):
    args, jargs = _both(*channels)
    want = JTOOL.pallas_block(*jargs, rows=8, interpret=True)
    y = tool.block_plain(*args)
    assert y.shape == (1, 56, 56, channels[2]) and y.dtype == torch.bfloat16
    assert _rel(y, want) <= 1e-2


#: sets only the general kernel takes, in both dtypes: cin not a multiple
#: of 16 and cmid 80; a Wide ResNet's stage-1 block (cmid 128)
GENERAL_SETS = [(24, 80, 40), (64, 128, 256)]


def test_inputs_take_a_dtype():
    """bf16 by default, as the JAX tool draws; f32 from the same values."""
    b = tool.inputs(1, 16, 16, 32, device="cpu", seed=5)
    f = tool.inputs(1, 16, 16, 32, device="cpu", seed=5,
                    dtype=torch.float32)
    assert [t.dtype for t in b] == [torch.bfloat16] * 4 + [torch.float32] * 2
    assert [t.dtype for t in f] == [torch.float32] * 6
    for tb, tf in zip(b, f):
        assert tb.shape == tf.shape
        assert torch.equal(tb, tf.to(tb.dtype))


@pytest.mark.parametrize("channels", CHANNELS + GENERAL_SETS, ids=str)
def test_plain_matches_the_pallas_kernel_in_f32(channels):
    """f32 in, f32 out (the JAX tool's ``yshape`` takes x's dtype)."""
    args, jargs = _both(*channels, seed=6, dtype=torch.float32)
    want = JTOOL.pallas_block(*jargs, rows=8, interpret=True)
    y = tool.block_plain(*args)
    assert y.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(y, want) <= 1e-5


@pytest.mark.parametrize("channels", GENERAL_SETS, ids=str)
def test_plain_matches_the_pallas_kernel_at_general_sets(channels):
    args, jargs = _both(*channels, seed=7)
    want = JTOOL.pallas_block(*jargs, rows=8, interpret=True)
    y = tool.block_plain(*args)
    assert y.dtype == torch.bfloat16
    assert _rel(y, want) <= 1e-2


@pytest.mark.parametrize("channels", CHANNELS, ids=str)
def test_library_block_matches_xla_block(channels):
    args, jargs = _both(*channels, seed=1)
    assert _rel(tool.library_block(*args), JTOOL.xla_block(*jargs)) <= 1e-2


def _unmasked(x, w1, w2, w3, s, b):
    """block_plain without the image-edge ring set to 0."""
    cin, cmid = w1.shape
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    a = torch.relu(xp * s[0, :cin] + b[0, :cin])
    t1 = torch.relu((a @ w1.float()) * s[1, :cmid] + b[1, :cmid])
    acc = sum(t1[:, dy:dy + 56, dx:dx + 56] @ w2[dy * 3 + dx].float()
              for dy in range(3) for dx in range(3))
    return torch.relu(acc * s[2, :cmid] + b[2, :cmid]) @ w3.float()


def test_edge_mask_matters_and_is_applied():
    """With large positive second shifts the padding cells would hold
    relu(b1) after the pointwise chain: the kernel must zero them, and the
    answer without that differs."""
    shifts = torch.full((3, 16), 0.05)
    shifts[1] = 1.0
    args, jargs = _both(16, 16, 32, seed=2, shifts=shifts)
    want = JTOOL.pallas_block(*jargs, rows=8, interpret=True)
    assert _rel(tool.block_plain(*args), want) <= 1e-2
    wrong = _unmasked(*args).to(torch.bfloat16)
    assert _rel(wrong, want) > 0.1


def test_block_kernel_on_the_cpu_is_the_plain_version():
    args = tool.inputs(1, 16, 16, 32, device="cpu")
    before = tool.block_kernel.launches
    y = tool.block_kernel(*args, rows=8)
    assert tool.block_kernel.launches == before
    assert torch.equal(y, tool.block_plain(*args))


@pytest.mark.parametrize("rows", tool.ROWS)
def test_block_kernel_on_the_cpu_takes_every_rows(rows):
    """Every band height the TPU kernel takes (the divisors of 56) is
    accepted, and none changes y."""
    args = tool.inputs(1, 16, 16, 32, device="cpu", seed=3)
    assert torch.equal(tool.block_kernel(*args, rows=rows),
                       tool.block_kernel(*args))


def test_block_kernel_refuses_other_shapes():
    x, w1, w2, w3, s, b = tool.inputs(1, 16, 16, 32, device="cpu")
    with pytest.raises(MXNetError, match="rows dividing"):
        tool.block_kernel(x[:, :28], w1, w2, w3, s, b)
    with pytest.raises(MXNetError, match="rows dividing"):
        tool.block_kernel(x, w1, w2, w3, s, b, rows=5)
    with pytest.raises(MXNetError, match="need w1"):
        tool.block_kernel(x, w1, w2[:, :8], w3, s, b)
    with pytest.raises(MXNetError, match="scales and shifts"):
        tool.block_kernel(x, w1, w2, w3, s[:, :8], b[:, :8])
    # cmid 80 and cin 24 lie outside the wgmma kernel's range: the general
    # kernel takes them (they raised before it existed)
    for cin, cmid in ((16, 80), (24, 16)):
        args = tool.inputs(1, cin, cmid, 32, device="cpu")
        assert tool.route(*args) == "general"
    # past the general kernel's limits, and mixed dtypes, raise before
    # anything is built (w2 at cmid 4096 as a view of one zero)
    for cin, cmid, cout in ((16, 4096, 32), (4096, 16, 32), (16, 16, 4096)):
        x4, w14 = torch.zeros(1, 56, 56, cin), torch.zeros(cin, cmid)
        w24 = torch.zeros(1, 1, 1).expand(9, cmid, cmid)
        s4 = torch.ones(3, max(cin, cmid))
        with pytest.raises(MXNetError, match="cmid and cout 1 to 2048"):
            tool._launch(x4, w14, w24, torch.zeros(cmid, cout), s4, s4)
    with pytest.raises(MXNetError, match="one dtype"):
        tool._launch(x.float(), w1, w2, w3, s, b)
    with pytest.raises(MXNetError, match="one dtype"):
        tool._launch(x.half(), w1.half(), w2.half(), w3.half(), s, b)
    for band in (5, 7):
        with pytest.raises(MXNetError, match="band"):
            tool._launch(x, w1, w2, w3, s, b, band=band)
    with pytest.raises(MXNetError, match="CUDA tensors"):
        tool._launch(x, w1, w2, w3, s, b)


@pytest.mark.parametrize("channels,takes", [
    ((64, 64, 256), True), ((256, 64, 256), True), ((16, 16, 32), True),
    ((48, 48, 80), True), ((208, 16, 48), True), ((256, 64, 16), True),
    ((24, 64, 256), False), ((64, 80, 256), False), ((64, 8, 256), False),
    ((64, 64, 272), False), ((0, 64, 256), False), ((64, 64, 40), False)],
    ids=str)
def test_kernel_takes_its_range(channels, takes):
    """cin and cout multiples of 16 in [16, 256], cmid 16, 32, 48 or 64:
    both stage-1 sets, the tests' set and chip_smoke's range sets.  What
    the wgmma kernel takes goes to it in bf16; the rest, and f32, to the
    general kernel where it takes them (cin 0 nowhere)."""
    assert tool.kernel_takes(*channels) is takes
    general = tool.general_takes(*channels)
    for dtype in (torch.bfloat16, torch.float32):
        args = tool.inputs(1, *channels, device="cpu", dtype=dtype) \
            if min(channels) > 0 else None
        want = "sm90" if takes and dtype == torch.bfloat16 \
            else "general" if general else None
        if args is None:
            assert want is None
        else:
            assert tool.route(*args) == want


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("channels,route_bf16", [
    ((64, 64, 256), "sm90"), ((256, 64, 256), "sm90"),
    ((16, 16, 32), "sm90"), ((64, 80, 256), "general"),
    ((24, 64, 256), "general"), ((64, 64, 272), "general"),
    ((64, 128, 256), "general"), ((256, 128, 256), "general"),
    ((1, 1, 1), "general"), ((3, 7, 5), "general"),
    ((2048, 256, 2048), "general"), ((64, 256, 64), "general"),
    ((64, 257, 64), "general"), ((512, 512, 64), "general"),
    ((64, 2048, 64), "general"), ((64, 2049, 64), None),
    ((64, 4096, 64), None), ((2049, 64, 64), None), ((64, 64, 2049), None)],
    ids=str)
def test_route_chooser(channels, route_bf16, dtype):
    """bf16 within the wgmma kernel's range goes there; f32 everywhere, and
    bf16 outside that range, to the general kernel up to cin, cmid and cout
    2048; past that the router raises, naming the limits.  The router
    builds nothing, so it runs on CPU tensors (w2 a view of one zero)."""
    cin, cmid, cout = channels
    dt = getattr(torch, dtype)
    x = torch.zeros(1, 56, 56, cin, dtype=dt)
    w1 = torch.zeros(cin, cmid, dtype=dt)
    w2 = torch.zeros(1, 1, 1, dtype=dt).expand(9, cmid, cmid)
    w3 = torch.zeros(cmid, cout, dtype=dt)
    s = torch.ones(3, max(cin, cmid))
    want = route_bf16 if dt == torch.bfloat16 or route_bf16 is None \
        else "general"
    if want is None:
        with pytest.raises(MXNetError, match="cmid and cout 1 to 2048"):
            tool.route(x, w1, w2, w3, s, s)
    else:
        assert tool.route(x, w1, w2, w3, s, s) == want


def test_chip_smoke_range_sets_are_in_range_and_cover_the_tails():
    """chip_smoke's batch-2 sets reach every cmid, a partial last x chunk
    and every width of y's last chunk."""
    sets = chip_smoke.K9_RANGE_SETS + [(16, 16, 32)] + list(tool.STAGE1_SETS)
    assert all(tool.kernel_takes(*c) for c in sets)
    assert {c[1] for c in sets} == {16, 32, 48, 64}
    assert {c[0] % 64 for c in sets} >= {0, 16, 48}
    assert {c[2] % 64 for c in sets} == {0, 16, 32, 48}


def test_general_kernel_source():
    """The general route: its own source in cuda_build.SOURCES, split TF32
    (m16n8k8 .tf32 from tf32_common.cuh, with its cvt.rna split) and bf16
    m16n8k16 on mma.sync, the chunk sums added on the CUDA cores, loads by
    threads (no TMA, so any channel count), no atomics and no library
    call."""
    from mxnet_tpu_torch import cuda_build
    assert cuda_build.SOURCES["bottleneck_block_general"] == \
        "csrc/bottleneck_block_general.cu"
    csrc = os.path.join(ROOT, "mxnet_tpu_torch", "csrc")
    with open(os.path.join(csrc, "bottleneck_block_general.cu")) as f:
        src = f.read()
    with open(os.path.join(csrc, "tf32_common.cuh")) as f:
        tf32 = f.read()
    assert '#include "tf32_common.cuh"' in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in tf32
    assert "cvt.rna.tf32.f32" in tf32
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    for used in ("tf32::mma3(", "tf32::split(", "acc[m][n][e] += p[m][n][e]",
                 "int mxtt_bottleneck_general(",
                 "int mxtt_bottleneck_general_plan("):
        assert used in src, used
    for gone in ("atomicadd", "atom.", "red.", "cublas", "cudnn",
                 "tma_load", "wgmma_", "wgmma.mma_async"):
        assert gone not in src.lower(), gone


def test_kernel_source_is_the_hopper_design():
    """K9 runs on wgmma fed by TMA (4-d x boxes, the weights in 2-d strips,
    a TMA store of y), with no mma.sync, cp.async or library call; it reads
    the 3x3's shifted t1 tiles through K-major interleaved descriptors and
    the weights through MN-major ones; no product is guarded on its own (a
    guard made ptxas serialize every wgmma)."""
    csrc = os.path.join(ROOT, "mxnet_tpu_torch", "csrc")
    with open(os.path.join(csrc, "bottleneck_block.cu")) as f:
        src = f.read()
    for gone in ("mma.sync", "cp.async.cg", "ldmatrix", "cublas", "cudnn",
                 "if (kk < ks)"):
        assert gone not in src
    for used in ("tma_load_4d", "tma_load_2d", "tma_store_2d",
                 "tma_prefetch_4d", "wgmma_ss<0, 1>", "wgmma_rs<1>",
                 "interleaved_kmajor", "interleaved_mnmajor", "mbar_wait",
                 "fence_proxy_async", "cvt.rn.relu.bf16x2.f32"):
        assert used in src or used in _common(csrc)


def _common(csrc):
    with open(os.path.join(csrc, "sm90_common.cuh")) as f:
        return f.read()


@pytest.mark.parametrize("variant", sorted(tool.VARIANTS))
def test_every_variant_finds_its_text(variant):
    """Each variant of the tool is a text edit of the committed kernel and
    must find what it replaces; it changes bottleneck_block.cu and nothing
    else.  The profile variant reads one clock sum a phase."""
    texts = tool._sources(variant, None)
    csrc = os.path.join(ROOT, "mxnet_tpu_torch", "csrc")
    with open(os.path.join(csrc, "bottleneck_block.cu")) as f:
        assert texts["bottleneck_block.cu"] != f.read()
    assert texts["sm90_common.cuh"] == _common(csrc)
    if variant == "profile":
        marks = texts["bottleneck_block.cu"].count("PMARK(")
        assert marks > len(tool.PROFILE_PHASES)
        assert "mxtt_bottleneck_block_profile" in texts["bottleneck_block.cu"]


def test_chip_smoke_reads_k9_ptxas_report():
    """chip_smoke's report of -Xptxas -v for bottleneck_block.cu: one entry
    a middle width, registers, shared memory and spills."""
    log = (
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__1f2e3d4c"
        "_19_bottleneck_block_cu_9a8b7c6d22bottleneck_sm90_kernelILi64EEEv"
        "14CUtensorMap_stS1_PKtS3_S3_PKfS5_NS_4PlanE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN55_GLOBAL__N__1f2e3d4c"
        "_19_bottleneck_block_cu_9a8b7c6d22bottleneck_sm90_kernelILi64EEEv"
        "14CUtensorMap_stS1_PKtS3_S3_PKfS5_NS_4PlanE\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
        "loads\n"
        "ptxas info    : Used 154 registers, used 1 barriers, 224 bytes "
        "smem\n")
    assert chip_smoke.block_ptxas_summary(log) == {
        "bottleneck_sm90_kernel<64>": {
            "stack": 0, "spill_stores": 8, "spill_loads": 8,
            "registers": 154, "smem": 224}}


def test_chip_smoke_reads_the_general_kernel_ptxas_report():
    """The same report for bottleneck_block_general.cu: one entry a dtype
    and tile height (``bottleneck_general_kernel<4>`` for f32 whole rows;
    the type argument is not an integer and is dropped, so the f32 and
    bf16 entries keep their order of appearance)."""
    log = (
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__0a1b2c3d"
        "_27_bottleneck_block_general_cu_1a2b3c4d25bottleneck_general_kernel"
        "IfLi4EEEvNS_6ParamsE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN48_GLOBAL__N__0a1b2c3d_27"
        "_bottleneck_block_general_cu_1a2b3c4d25bottleneck_general_kernelIf"
        "Li4EEEvNS_6ParamsE\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__0a1b2c3d"
        "_27_bottleneck_block_general_cu_1a2b3c4d25bottleneck_general_kernel"
        "I13__nv_bfloat16Li2EEEvNS_6ParamsE' for 'sm_90a'\n"
        "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n")
    assert chip_smoke.general_block_ptxas_summary(log) == {
        "bottleneck_general_kernel<f32,4>": {
            "stack": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 96, "smem": 0},
        "bottleneck_general_kernel<bf16,2>": {
            "stack": 0, "spill_stores": 4, "spill_loads": 4,
            "registers": 128, "smem": 0}}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 8, 56])
@pytest.mark.parametrize("channels", CHANNELS, ids=str)
def test_kernel_matches_plain_on_card(cuda_device, channels, rows):
    args = tool.inputs(2, *channels, device=cuda_device)
    before = tool.block_kernel.launches
    y = tool.block_kernel(*args, rows=rows).float()
    torch.cuda.synchronize()
    assert tool.block_kernel.launches == before + 1
    ref = tool.block_plain(*args).float()
    assert (y - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("band", [2, 14, 56])
@pytest.mark.parametrize("channels", CHANNELS, ids=str)
def test_kernel_is_the_same_at_every_band_on_card(cuda_device, channels,
                                                  band):
    """A forced band height gives the bits of the kernel's own choice."""
    args = tool.inputs(2, *channels, device=cuda_device)
    assert torch.equal(tool._launch(*args, band=band), tool._launch(*args))


@pytest.mark.cuda
def test_kernel_refuses_other_shapes_on_card(cuda_device):
    """cmid 4096 lies past the general kernel's limit in both dtypes."""
    for dtype in (torch.bfloat16, torch.float32):
        args = list(tool.inputs(1, 64, 64, 256, device=cuda_device,
                                dtype=dtype))
        args[1] = torch.zeros(64, 4096, dtype=dtype, device=cuda_device)
        args[2] = torch.zeros(1, 1, 1, dtype=dtype,
                              device=cuda_device).expand(9, 4096, 4096)
        args[3] = torch.zeros(4096, 256, dtype=dtype, device=cuda_device)
        args[4] = args[5] = torch.ones(3, 4096, device=cuda_device)
        with pytest.raises(MXNetError, match="cmid and cout 1 to 2048"):
            tool.block_kernel(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("channels", [(64, 80, 256), (24, 64, 256),
                                      (64, 64, 272), (64, 128, 256),
                                      (3, 7, 5)] + CHANNELS, ids=str)
def test_general_kernel_matches_plain_on_card(cuda_device, channels, dtype):
    """The general kernel: bf16 outside the wgmma kernel's range, and f32
    at every set, against block_plain (bf16 at the JAX tool's 5e-2, f32 at
    chip_smoke's TOL_BLOCK_F32), bit-identical across two launches."""
    dt = getattr(torch, dtype)
    args = tool.inputs(2, *channels, device=cuda_device, dtype=dt)
    if dt == torch.bfloat16 and tool.kernel_takes(*channels):
        pytest.skip("the wgmma kernel's set")
    before = tool.block_kernel.general_launches
    y = tool.block_kernel(*args)
    y2 = tool.block_kernel(*args)
    torch.cuda.synchronize()
    assert tool.block_kernel.general_launches == before + 2
    assert y.dtype == dt and torch.equal(y, y2)
    ref = tool.block_plain(*args).float()
    tol = chip_smoke.TOL_BLOCK_F32 if dt == torch.float32 \
        else chip_smoke.TOL_BLOCK
    assert (y.float() - ref).abs().max().item() \
        <= tol * ref.abs().max().item()


def test_chip_smoke_block_bound_takes_the_dtype():
    """bf16: 2-byte x, y and weights at 989 TFLOP/s; f32: 4-byte ones and
    split TF32, 3 x flops at 495 TFLOP/s, which bounds both stage-1 sets in
    f32 by operations."""
    n, cin, cmid, cout = 128, 64, 64, 256
    flops = 2.0 * n * 56 * 56 * (cin * cmid + 9 * cmid * cmid + cmid * cout)
    weights = cin * cmid + 9 * cmid * cmid + cmid * cout
    bf = chip_smoke.block_bound(n, cin, cmid, cout)
    f32 = chip_smoke.block_bound(n, cin, cmid, cout, torch.float32)
    assert bf == chip_smoke.block_bound(n, cin, cmid, cout, torch.bfloat16)
    assert bf["bytes"] == 2.0 * n * 56 * 56 * (cin + cout) + 2.0 * weights \
        + 4.0 * 2 * 3 * cin
    assert f32["bytes"] == 4.0 * n * 56 * 56 * (cin + cout) + 4.0 * weights \
        + 4.0 * 2 * 3 * cin
    assert bf["bound_by"] == "bytes"
    assert f32["bound_by"] == "operations"
    assert f32["bound_ms"] == 3 * flops / 495e12 * 1e3


def test_chip_smoke_general_sets_take_the_general_route():
    """chip_smoke's batch-2 sets for the general kernel lie outside the
    wgmma kernel's range (in bf16) and inside the general one's, the f32
    extras reach odd counts and cmid 256 (half rows in f32), and the wide
    sets cmid 512 in both dtypes and 1024, tiles narrower than 28."""
    for channels in chip_smoke.K9_GENERAL_SETS:
        assert not tool.kernel_takes(*channels)
        assert tool.general_takes(*channels)
    assert {(64, 80, 256), (24, 64, 256), (64, 64, 272),
            (64, 128, 256)} <= set(chip_smoke.K9_GENERAL_SETS)
    extra = chip_smoke.K9_GENERAL_F32_EXTRA
    assert all(tool.general_takes(*c) for c in extra)
    assert any(c[1] == 256 for c in extra)
    assert any(min(c) < 8 and all(v % 2 for v in c) for c in extra)
    wide = chip_smoke.K9_WIDE_SETS
    assert all(tool.general_takes(*c) for c, _dt in wide)
    assert {(c[1], dt) for c, dt in wide} >= {
        (512, torch.float32), (512, torch.bfloat16)}
    assert any(c[1] == 1024 for c, _dt in wide)
    assert {chip_smoke.K9_TILES[c[1], dt] for c, dt in wide} \
        >= {28, 14, 8}
    assert not tool.general_takes(64, 4096, 256)
    assert chip_smoke.K9_REFUSED == (64, 4096, 256)


#: the general kernel's wide sets: cmid 512 (in both dtypes through the JAX
#: tool, which takes cin >= cmid)
WIDE_SETS = [(512, 512, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", WIDE_SETS, ids=str)
def test_plain_matches_the_pallas_kernel_at_cmid_512(channels, dtype):
    """cmid 512, which the general kernel took only from its tiles of 14
    positions on: block_plain against the Pallas kernel in interpret mode
    at batch 1, rows 8 (f32 1e-5, bf16 1e-2 of max |y|)."""
    dt = getattr(torch, dtype)
    args, jargs = _both(*channels, seed=8, dtype=dt)
    want = JTOOL.pallas_block(*jargs, rows=8, interpret=True)
    y = tool.block_plain(*args)
    assert y.dtype == dt and y.shape == (1, 56, 56, channels[2])
    assert _rel(y, want) <= (1e-5 if dt == torch.float32 else 1e-2)


@pytest.mark.parametrize("cmid,dtype,tile", [
    (cmid, str(dt).replace("torch.", ""), tile)
    for (cmid, dt), tile in chip_smoke.K9_TILES.items()])
def test_tile_plan_takes_the_widest_tile_that_fits(cmid, dtype, tile):
    """The tiles chip_smoke holds the general kernel's own plan to: whole
    rows while three haloed t1 rows, a t2 row and the chunk buffers (the
    tile's 16, 32 or 64 product rows and 64 of the weights, 32 deep) fit a
    block's 232448 bytes, else the widest narrower divisor of 56 that
    fits."""
    dt = getattr(torch, dtype)
    pad = 4 if dt == torch.float32 else 8
    row = (cmid + 63) // 64 * 64 + pad

    def smem(tw):
        rows = 64 if tw == 56 else 32 if tw == 28 else 16
        return dt.itemsize * ((3 * (tw + 2) + tw) * row
                              + (rows + 64) * (32 + pad))
    widths = [w for w in range(56, 0, -1) if 56 % w == 0]
    assert tile == next(w for w in widths if smem(w) <= 232448)
