"""K9, the stage-1 bottleneck block: the port's ``block_plain`` against the
JAX tool's Pallas kernel (``tools/pallas_block_experiment.py``, loaded by
path) in interpret mode, and ``library_block`` against its ``xla_block``,
on the same bf16 inputs from a seed, at batch 1.

Tolerances, as a share of max |y|: 1e-2.  ``block_plain`` and the Pallas
kernel both compute in f32 and round y to bf16 once, so they differ by the
rounding of a y whose f32 values differ in their last bits (one bf16 ulp,
under 4e-3 of an entry); ``library_block`` and ``xla_block`` round at the
same four places.  The ``cuda`` tests hold the CUDA kernel against
``block_plain`` on the card at the JAX tool's limit, 5e-2, at both stage-1
channel sets and several band heights.
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


def _both(cin, cmid, cout, seed=0, shifts=None):
    """The tool's inputs at batch 1 for the port and, from the same values,
    for JAX."""
    args = list(tool.inputs(1, cin, cmid, cout, device="cpu", seed=seed))
    if shifts is not None:
        args[5] = shifts
    jargs = [jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)
        for a in args]
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
    # the CUDA path checks the kernel's range before building: cmid 80 and
    # cin 24 lie outside it
    for cin, cmid in ((16, 80), (24, 16)):
        args = tool.inputs(1, cin, cmid, 32, device="cpu")
        with pytest.raises(MXNetError, match="takes cin and cout"):
            tool._launch(*args)
    with pytest.raises(MXNetError, match="bf16"):
        tool._launch(x.float(), w1, w2, w3, s, b)
    for band in (5, 7):
        with pytest.raises(MXNetError, match="band"):
            tool._launch(x, w1, w2, w3, s, b, band=band)


@pytest.mark.parametrize("channels,takes", [
    ((64, 64, 256), True), ((256, 64, 256), True), ((16, 16, 32), True),
    ((48, 48, 80), True), ((208, 16, 48), True), ((256, 64, 16), True),
    ((24, 64, 256), False), ((64, 80, 256), False), ((64, 8, 256), False),
    ((64, 64, 272), False), ((0, 64, 256), False), ((64, 64, 40), False)],
    ids=str)
def test_kernel_takes_its_range(channels, takes):
    """cin and cout multiples of 16 in [16, 256], cmid 16, 32, 48 or 64:
    both stage-1 sets, the tests' set and chip_smoke's range sets."""
    assert tool.kernel_takes(*channels) is takes


def test_chip_smoke_range_sets_are_in_range_and_cover_the_tails():
    """chip_smoke's batch-2 sets reach every cmid, a partial last x chunk
    and every width of y's last chunk."""
    sets = chip_smoke.K9_RANGE_SETS + [(16, 16, 32)] + list(tool.STAGE1_SETS)
    assert all(tool.kernel_takes(*c) for c in sets)
    assert {c[1] for c in sets} == {16, 32, 48, 64}
    assert {c[0] % 64 for c in sets} >= {0, 16, 48}
    assert {c[2] % 64 for c in sets} == {0, 16, 32, 48}


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
    args = tool.inputs(1, 64, 80, 256, device=cuda_device)
    with pytest.raises(MXNetError, match="takes cin and cout"):
        tool.block_kernel(*args)
