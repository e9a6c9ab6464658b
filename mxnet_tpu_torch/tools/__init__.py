"""Command-line tools of the port, run as ``python -m
mxnet_tpu_torch.tools.<name>``."""
from __future__ import annotations

import subprocess


def nvidia_smi():
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (its first line): a
    card set below its 700 W maximum runs slower under load, so every
    measurement carries this line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_counts():
    """The launch counts of the port's hand-written kernels, as each
    wrapper keeps them (the flash wrappers count either route)."""
    from ..ops.fused import matmul_stats, matmul_stats_prologue
    from ..ops.flash_attention import (flash_attention_bwd,
                                       flash_attention_delta,
                                       flash_attention_fwd)
    from ..rtc import Rtc
    from .block_experiment import block_kernel
    return {"flash_attention_fwd": flash_attention_fwd.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "flash_attention_delta": flash_attention_delta.launches,
            "matmul_stats": matmul_stats.launches,
            "matmul_stats_f32": matmul_stats.f32_launches,
            "matmul_stats_prologue": matmul_stats_prologue.launches,
            "rtc": Rtc.launches,
            "bottleneck_block": block_kernel.launches,
            "bottleneck_block_general": block_kernel.general_launches}


def zero_kernel_counts():
    """Set every count of :func:`kernel_counts` to 0, and the flash
    wrappers' counts by source."""
    from ..ops.fused import matmul_stats, matmul_stats_prologue
    from ..ops.flash_attention import (flash_attention_bwd,
                                       flash_attention_delta,
                                       flash_attention_fwd)
    from ..rtc import Rtc
    from .block_experiment import block_kernel
    for f in (flash_attention_fwd, flash_attention_bwd,
              flash_attention_delta):
        f.launches = 0
    for f in (flash_attention_fwd, flash_attention_bwd):
        for name in f.source_launches:
            f.source_launches[name] = 0
    matmul_stats.launches = matmul_stats.f32_launches = 0
    matmul_stats_prologue.launches = 0
    Rtc.launches = 0
    block_kernel.launches = block_kernel.general_launches = 0
