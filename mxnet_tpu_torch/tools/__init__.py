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
