"""The autotuner's timing runner: the counterpart of
``mxnet_tpu/autotune/search.py`` :func:`measure`."""
from __future__ import annotations

import time

import torch

__all__ = ["measure"]


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn, args=(), repeats=3, chain=1):
    """Min-of-N wall seconds of one ``fn(*args)`` application.

    One untimed call first (it builds and loads what the call needs).  Each
    of ``repeats`` samples then runs ``chain`` applications back to back and
    is closed by ``torch.cuda.synchronize()`` when the card is in use, by
    the host clock alone on the CPU; the least sample is divided by
    ``chain``.  The JAX runner chains its applications inside one jitted
    ``lax.scan`` with a data dependence between them, so that XLA neither
    merges them nor pays a dispatch for each; eager PyTorch runs every call
    as it is called and enqueues kernels without waiting for them, so a plain
    loop does the same here.
    """
    args = tuple(args)
    chain = max(1, int(chain))
    fn(*args)
    _sync()
    walls = []
    for _ in range(max(1, int(repeats))):
        t0 = time.perf_counter()
        for _ in range(chain):
            fn(*args)
        _sync()
        walls.append(time.perf_counter() - t0)
    return min(walls) / chain
