"""mxnet_tpu_torch.analysis: static verification before any device time.

The counterpart of ``mxnet_tpu/analysis``:

* the **graph verifier** (:mod:`.verifier`, MXG001-009): per-node abstract
  interpretation of a Symbol DAG on the ``meta`` device — shape and dtype
  consistency against the op registry's fcompute contracts, missing
  param-shape rules, dead nodes and unused inputs, duplicate names,
  cycles, and tensor-parallel sharding coverage against
  :mod:`mxnet_tpu_torch.parallel.tp_rules`.  Exposed as
  ``Symbol.verify()``, ``bind(..., strict=True)``,
  ``ShardedTrainer(strict=True)``, ``MXNET_TPU_STRICT_BIND=1`` and
  ``python -m mxnet_tpu_torch.analysis``;
* the **static memory-liveness analyzer** (:mod:`.memlive`, MXG017-021):
  predicted peak device memory with a per-category breakdown, the budget
  gate before any op runs, remat candidates, the ZeRO and donation
  audits;
* the **predicted-slow check** (:mod:`.perf`, MXG010) over a fitted
  :class:`mxnet_tpu_torch.autotune.CostModel`;
* the **block-fusion planner** (:mod:`.fusion`) and the **plan search**
  (:mod:`.plansearch`): the cost-model-guided search over its decisions,
  committed to the tuning cache and consulted at bind time;
* the **source linter** of ``tools/mxlint.py`` (stdlib only), loaded by
  path by :func:`load_mxlint`.

Not yet ported: the distributed-correctness pass (JAX ``analysis/spmd.py``,
ROADMAP Queue A item 4).
"""
from __future__ import annotations

import os

from ..base import MXNetError
from .verifier import (Diagnostic, Report, verify_symbol, verify_json,
                       verify_model, infer_node_shapes)
from . import fusion
from . import memlive
from . import perf
from . import plansearch
from .fusion import plan_block_fusion, last_plan_summary
from .memlive import LivenessAnalysis, analyze_memory, check_memory
from .perf import check_predicted_slow, check_predicted_plan

__all__ = ["Diagnostic", "Report", "verify_symbol", "verify_json",
           "verify_model", "infer_node_shapes", "load_mxlint",
           "registry_selfcheck", "fusion", "memlive", "perf",
           "plansearch", "plan_block_fusion", "last_plan_summary",
           "check_predicted_slow", "check_predicted_plan",
           "LivenessAnalysis", "analyze_memory", "check_memory"]


def registry_selfcheck():
    """Run the op-registry self-check; returns a list of problem strings
    (see :func:`mxnet_tpu_torch.ops.registry.selfcheck`)."""
    from ..ops import registry as _registry
    return _registry.selfcheck()


_MXLINT_CACHE = None


def load_mxlint():
    """Import the standalone linter in ``tools/mxlint.py`` by its path.

    The linter is stdlib only and is not a package module; loading it by
    file path, as the JAX package does, keeps one implementation for the
    CLI and the tests.  It needs a source checkout."""
    global _MXLINT_CACHE
    if _MXLINT_CACHE is not None:
        return _MXLINT_CACHE
    import importlib.util
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(repo_root, "tools", "mxlint.py")
    if not os.path.exists(path):
        raise MXNetError("tools/mxlint.py not found at %r (linting "
                         "requires a source checkout)" % path)
    spec = importlib.util.spec_from_file_location("mxlint", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _MXLINT_CACHE = mod
    return mod
