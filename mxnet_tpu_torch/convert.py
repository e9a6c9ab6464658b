"""Carry weights from the JAX package into the port.

Weights keep their MXNet layouts in both packages (FullyConnected weight
``(out, in)``, Embedding ``(vocab, d)``, LayerNorm gamma/beta ``(d,)``,
Convolution weight OIHW, BatchNorm statistics ``(C,)``), so converting is
placing arrays on a device.  The file route needs no code:
a ``.params`` file written by ``mxnet_tpu.nd.save`` loads with
``mxnet_tpu_torch.nd.load``, and the reverse.  A training state carries
over with :func:`from_jax_trainer_state`, a module's parameters (a
``Module``'s or a ``BucketingModule``'s) with :func:`from_jax_module`.
A ``FusedRNNCell``'s flat ``parameters`` vector has the same layout in
both packages (per layer and direction the input then the recurrent
weights, gate-major, then all biases; LSTM gates i, f, g, o, GRU r, z,
n), so it carries over as it is.
"""
from __future__ import annotations

import numpy as np

import torch

from .base import MXNetError
from .ndarray import NDArray, _from_numpy
from .context import current_context

__all__ = ["from_jax_params", "from_jax_module", "from_jax_trainer_state"]


def from_jax_params(params, ctx=None):
    """``{name: array}`` (numpy arrays, or anything ``np.asarray`` takes,
    such as the JAX package's NDArrays) -> ``{name: NDArray}`` on ``ctx``
    (default: the current context).  The ``arg:``/``aux:`` prefixes of a
    checkpoint are stripped and dtypes are kept."""
    device = (ctx or current_context()).torch_device()
    out = {}
    for k, v in params.items():
        name = k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k
        out[name] = NDArray(_from_numpy(np.asarray(v)).to(device))
    return out


def from_jax_module(module, ctx=None):
    """``(arg_params, aux_params)`` of a JAX package module (anything with
    ``get_params()``), as NDArrays on ``ctx`` (default: the host, where a
    module's ``set_params``/``init_params`` take them)."""
    from .context import cpu
    args, auxs = module.get_params()
    ctx = ctx or cpu()
    return from_jax_params(args, ctx), from_jax_params(auxs, ctx)


def from_jax_trainer_state(trainer, params, opt_state=None, aux=None):
    """Copy a JAX ``ShardedTrainer``'s state into the port's ``trainer``, in
    place, on the trainer's device.  ``params``: ``{name: array}`` (numpy,
    or anything ``np.asarray`` takes); ``opt_state``: ``{name: [slot
    arrays]}`` in the JAX trainer's slot order, which is the port's;
    ``aux``: ``{name: array}``, the auxiliary states (BatchNorm's moving
    statistics).  Names, shapes and slot counts must match the port's
    trainer."""
    def put(dst, src, what):
        src = np.asarray(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise MXNetError("%s: shape %s, the trainer has %s"
                             % (what, src.shape, tuple(dst.shape)))
        dst.copy_(torch.from_numpy(np.array(src, np.float32)))

    for kind, given, mine in (("params", params, trainer.params),
                              ("aux", aux, trainer.aux)):
        if given is not None and set(given) != set(mine):
            raise MXNetError("%s: names differ from the trainer's: %s"
                             % (kind, sorted(set(given) ^ set(mine))))
    with torch.no_grad():
        for name, value in params.items():
            put(trainer.params[name], value, name)
        for name, value in (aux or {}).items():
            put(trainer.aux[name], value, "aux " + name)
        for name, slots in (opt_state or {}).items():
            mine = trainer.opt_state[name]
            if len(slots) != len(mine):
                raise MXNetError("opt_state %r: %d slots, the trainer has %d"
                                 % (name, len(slots), len(mine)))
            for i, value in enumerate(slots):
                put(mine[i], value, "%s slot %d" % (name, i))
