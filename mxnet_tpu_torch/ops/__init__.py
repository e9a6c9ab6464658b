"""Operator package: the registry and the ported op corpus.

Importing this package registers the ops; ``mx.sym.<op>`` functions are
generated from the same table in :mod:`mxnet_tpu_torch.symbol`.
"""
from __future__ import annotations

from . import registry
from .registry import OpContext, Operator, apply_op, get_op, list_ops, \
    register
from . import tensor as _tensor              # noqa: F401
from . import nn as _nn                      # noqa: F401
from . import optimizer_ops as _opt          # noqa: F401
from . import flash_attention as _flash      # noqa: F401
from . import rnn as _rnn                    # noqa: F401
from . import contrib as _contrib            # noqa: F401
from . import contrib_dense as _contrib_dense  # noqa: F401
from . import spatial as _spatial            # noqa: F401
from .. import operator as _operator         # noqa: F401  (Custom)

__all__ = ["OpContext", "Operator", "register", "get_op", "list_ops",
           "apply_op"]
