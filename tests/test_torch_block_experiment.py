"""K9, the stage-1 bottleneck block: the port's ``block_plain`` against the
JAX tool's Pallas kernel (``tools/pallas_block_experiment.py``, loaded by
path) in interpret mode, and ``library_block`` against its ``xla_block``,
on the same bf16 inputs from a seed, at batch 1.

Tolerances, as a share of max |y|: 1e-2.  ``block_plain`` and the Pallas
kernel both compute in f32 and round y to bf16 once, so they differ by the
rounding of a y whose f32 values differ in their last bits (one bf16 ulp,
under 4e-3 of an entry); ``library_block`` and ``xla_block`` round at the
same four places.  The ``cuda`` test holds the CUDA kernel against
``block_plain`` on the card at the JAX tool's limit, 5e-2.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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


@pytest.mark.parametrize("channels", [(16, 16, 32), (64, 64, 256)], ids=str)
def test_plain_matches_the_pallas_kernel(channels):
    args, jargs = _both(*channels)
    want = JTOOL.pallas_block(*jargs, rows=8, interpret=True)
    y = tool.block_plain(*args)
    assert y.shape == (1, 56, 56, channels[2]) and y.dtype == torch.bfloat16
    assert _rel(y, want) <= 1e-2


@pytest.mark.parametrize("channels", [(16, 16, 32), (64, 64, 256)], ids=str)
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
    # the CUDA path checks what the kernel instantiates before building
    with pytest.raises(MXNetError, match="instantiates|takes"):
        tool._launch(x, w1, w2, w3, s, b, 8)
    with pytest.raises(MXNetError, match="bf16"):
        tool._launch(x.float(), w1, w2, w3, s, b, 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("config", tool.KERNEL_CONFIGS, ids=str)
def test_kernel_matches_plain_on_card(cuda_device, config):
    cin, cmid, cout, rows = config
    args = tool.inputs(2, cin, cmid, cout, device=cuda_device)
    before = tool.block_kernel.launches
    y = tool.block_kernel(*args, rows=rows).float()
    torch.cuda.synchronize()
    assert tool.block_kernel.launches == before + 1
    ref = tool.block_plain(*args).float()
    assert (y - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
