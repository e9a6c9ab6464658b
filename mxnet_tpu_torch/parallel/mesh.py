"""Device meshes: the name ``ShardedTrainer`` takes its devices by.

The counterpart of ``mxnet_tpu/parallel/mesh.py``.  The JAX package builds
a ``jax.sharding.Mesh`` whose axes (``data``, ``model``, ``pipe``) name the
kinds of parallelism.  The port runs on one device so far: a mesh is one
context, with the JAX mesh's axis names, each of size 1.  More devices,
tensor parallelism (``tp``) and pipeline stages (``pp``) are not yet ported
and raise.
"""
from __future__ import annotations

from ..base import MXNetError
from ..context import Context, gpu

__all__ = ["Mesh", "build_mesh"]


class Mesh:
    """A one-device mesh on ``ctx``; ``shape`` maps each axis name to 1."""

    def __init__(self, ctx, axis_names=("data", "model")):
        if not isinstance(ctx, Context):
            raise TypeError("a mesh device is a Context (mx.gpu(0), "
                            "mx.cpu()), got %r" % (ctx,))
        self.ctx = ctx
        self.device = ctx.torch_device()   # raises for a missing card
        self.axis_names = tuple(axis_names)
        self.shape = {a: 1 for a in self.axis_names}

    def __repr__(self):
        return "Mesh(%s, axes=%s)" % (self.ctx, self.shape)


def build_mesh(n_devices=None, tp=1, pp=1, axis_names=None, devices=None):
    """A mesh over one device: ``devices[0]`` when given (a Context),
    else ``gpu(0)``.  ``n_devices`` other than None or 1, ``tp > 1``,
    ``pp > 1`` and more than one device raise: multi-device meshes are not
    yet ported."""
    if tp != 1 or pp != 1:
        raise MXNetError("build_mesh: tensor and pipeline parallelism "
                         "(tp=%r, pp=%r) are not yet ported to "
                         "mxnet_tpu_torch" % (tp, pp))
    if n_devices not in (None, 1) or (devices is not None
                                      and len(devices) != 1):
        raise MXNetError("build_mesh: meshes of more than one device are "
                         "not yet ported to mxnet_tpu_torch")
    ctx = devices[0] if devices is not None else gpu(0)
    return Mesh(ctx, axis_names or ("data", "model"))
