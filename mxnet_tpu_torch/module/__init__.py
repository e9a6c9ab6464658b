"""The Module API: ``BaseModule``, ``Module``, ``BucketingModule``,
``SequentialModule``, ``PythonModule``, ``PythonLossModule`` and
``DataParallelExecutorGroup``.

The counterpart of ``mxnet_tpu/module/``.
"""
from .base_module import BaseModule
from .module import Module
from .executor_group import DataParallelExecutorGroup
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup",
           "BucketingModule", "SequentialModule", "PythonModule",
           "PythonLossModule"]
