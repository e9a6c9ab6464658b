"""Training on devices: the counterpart of ``mxnet_tpu/parallel``.
``build_mesh`` gives this process's device on a mesh whose data axis
spans the processes of a job (``multihost``), and ``ShardedTrainer``
trains a Symbol on it; ``dist_kvstore``, ``async_kvstore`` and
``overlap`` are the distributed stores and the bucketed gradient
all-reduce."""
from .mesh import Mesh, build_mesh
from .trainer import ShardedTrainer
from . import multihost

__all__ = ["Mesh", "build_mesh", "ShardedTrainer", "multihost"]
