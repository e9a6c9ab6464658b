"""Device meshes: the name ``ShardedTrainer`` takes its devices by.

The counterpart of ``mxnet_tpu/parallel/mesh.py``.  The JAX package builds
a ``jax.sharding.Mesh`` whose axes (``data``, ``model``, ``pipe``) name the
kinds of parallelism.  The port's mesh is this process's one device plus,
inside a job of several processes (``tools/launch.py``), a ``data`` axis
that spans them: each process contributes one device, and the axis's size
is the job's world.  Tensor parallelism (``tp``), pipeline stages (``pp``)
and more than one device per process raise: they come with the next slice
of multi-GPU work (ROADMAP Queue A item 4).
"""
from __future__ import annotations

from ..base import MXNetError
from ..context import Context, gpu

__all__ = ["Mesh", "build_mesh"]

_NEXT_SLICE = ("not yet ported to mxnet_tpu_torch (model parallelism: "
               "the next slice of ROADMAP Queue A item 4)")


class Mesh:
    """This process's device ``ctx`` on a mesh whose ``data`` axis spans
    ``world`` processes (1: a one-device mesh); ``shape`` maps each axis
    name to its size."""

    def __init__(self, ctx, axis_names=("data", "model"), world=1):
        if not isinstance(ctx, Context):
            raise TypeError("a mesh device is a Context (mx.gpu(0), "
                            "mx.cpu()), got %r" % (ctx,))
        self.ctx = ctx
        self.device = ctx.torch_device()   # raises for a missing card
        self.axis_names = tuple(axis_names)
        self.world = int(world)
        self.shape = {a: (self.world if i == 0 else 1)
                      for i, a in enumerate(self.axis_names)}

    def __repr__(self):
        return "Mesh(%s, axes=%s)" % (self.ctx, self.shape)


def build_mesh(n_devices=None, tp=1, pp=1, axis_names=None, devices=None):
    """The mesh of this process: ``devices[0]`` when given (a Context), else
    the rank's card (``gpu(rank % device_count)``).  Inside a job
    (``MXNET_TPU_NUM_PROCESSES`` > 1 or a coordinator set) the process
    group is joined here and the data axis spans it; ``n_devices``, when
    given, must equal the job's world.  ``tp > 1``, ``pp > 1`` and more
    than one device in this process raise."""
    if tp != 1 or pp != 1:
        raise MXNetError("build_mesh: tensor and pipeline parallelism "
                         "(tp=%r, pp=%r) are %s" % (tp, pp, _NEXT_SLICE))
    if devices is not None and len(devices) != 1:
        raise MXNetError("build_mesh: %d devices in one process; each "
                         "process contributes one device to the data "
                         "axis (more are %s)" % (len(devices), _NEXT_SLICE))
    from . import multihost
    world = multihost.ensure_initialized()
    if n_devices not in (None, world):
        raise MXNetError(
            "build_mesh: n_devices=%r, but the job has %d process(es) of "
            "one device each (more devices a process are %s)"
            % (n_devices, world, _NEXT_SLICE))
    if devices is not None:
        ctx = devices[0]
    else:
        dev = multihost.device()
        ctx = gpu(dev.index) if dev.type == "cuda" else gpu(0)
    return Mesh(ctx, axis_names or ("data", "model"), world=world)
