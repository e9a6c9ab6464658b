"""mxnet_tpu_torch.autotune: the measurement runner of the autotuner.

The counterpart of ``mxnet_tpu/autotune``, reduced to :func:`measure`, the
one timing code path the kernel experiments in ``mxnet_tpu_torch.tools``
share.  The tuners, the tuning cache and the learned cost model are not
ported yet.
"""
from __future__ import annotations

from .search import measure

__all__ = ["measure"]
