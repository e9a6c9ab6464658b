"""Seeded generators: ``mx.random.seed`` and the draws of stochastic ops.

The counterpart of ``mxnet_tpu/random.py``.  The JAX package keeps one root
PRNG key and splits a subkey off per forward; here each device has one
explicit ``torch.Generator`` (the host's and one per CUDA device), made from
the last :func:`seed` (0 until one is set).  The stochastic ops (Dropout,
rrelu, the samplers ``mx.nd._random_*``, :func:`uniform`, :func:`normal`)
draw from the generator of the device they run on; nothing draws from
torch's global RNG.  The same seed gives the same bits on the same
device; the draws differ from the JAX package's.
"""
from __future__ import annotations

import threading

import torch


__all__ = ["seed", "generator", "uniform", "normal"]

_state = threading.local()
_DEFAULT_SEED = 0


def _generators():
    if not hasattr(_state, "gens"):
        _state.seed = _DEFAULT_SEED
        _state.gens = {}
    return _state.gens


def seed(seed_state):
    """Seed every generator: those made so far start over from
    ``seed_state``, and those made later start from it."""
    gens = _generators()
    _state.seed = int(seed_state)
    for gen in gens.values():
        gen.manual_seed(_state.seed)


def generator(device):
    """The ``torch.Generator`` of ``device`` (a ``torch.device``)."""
    gens = _generators()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    gen = gens.get(key)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_state.seed)
        gens[key] = gen
    return gen



def uniform(low=0.0, high=1.0, shape=(1,), ctx=None, dtype="float32",
            out=None):
    """Draws from U(low, high) on ``ctx`` (default: the current
    context)."""
    from . import ndarray as nd
    return nd.invoke("_random_uniform", low=low, high=high, shape=shape,
                     dtype=dtype, ctx=ctx, out=out)


def normal(loc=0.0, scale=1.0, shape=(1,), ctx=None, dtype="float32",
           out=None):
    """Draws from N(loc, scale^2) on ``ctx`` (default: the current
    context)."""
    from . import ndarray as nd
    return nd.invoke("_random_normal", loc=loc, scale=scale, shape=shape,
                     dtype=dtype, ctx=ctx, out=out)
