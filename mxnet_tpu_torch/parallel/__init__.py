"""Training on devices: the counterpart of ``mxnet_tpu/parallel``.  One
device so far: ``build_mesh`` gives a one-device mesh and
``ShardedTrainer`` trains a Symbol on it."""
from .mesh import Mesh, build_mesh
from .trainer import ShardedTrainer

__all__ = ["Mesh", "build_mesh", "ShardedTrainer"]
