"""mxnet_tpu_torch.autotune: the tuners, the tuning cache and the learned
cost model.

The counterpart of ``mxnet_tpu/autotune``, with its ``__all__``:

* :mod:`.search`: the timing runner (:func:`measure`, and
  :func:`~.search.measure_device` on the card) and the tuners
  (:func:`tune_flash`, :func:`tune_matmul_stats`, :func:`tune_conv_block`),
  which enumerate the tiles the hand-written CUDA kernels take, measure
  each, record each in the cost database and commit the winner;
* :mod:`.cache`: the persistent tuning cache (``mxtpu-tunecache/1`` under
  ``MXNET_TPU_TUNE_CACHE``, merged on load, best measured wall winning),
  which the flash and K5 wrappers and the fusion planner consult under
  ``MXNET_TPU_AUTOTUNE=off|cache|search``; the JAX package reads its files
  and it reads theirs;
* :mod:`.model`: the learned cost model (:class:`CostModel`, a numpy ridge
  regression of ``log(wall)`` fit on the cost database's records), which
  MXG010, the plan search and the serving ladder read.

Command lines: ``python -m mxnet_tpu_torch.tools.autotune`` and
``python -m mxnet_tpu_torch.tools.plan_search``.
"""
from __future__ import annotations

from .cache import (SCHEMA, TuneCache, CACHE, autotune_mode, cache_dir,
                    key_sig, kernel_config, block_config, lookup, put,
                    read_entries, reload_cache, summary, reset_stats)
from .search import (measure, divisors, candidate_flash_configs,
                     candidate_matmul_configs, tune_flash,
                     tune_matmul_stats, tune_conv_block, inline_search,
                     same_config)
from .model import (CostModel, FEATURES, featurize, fit_cost_model,
                    load_model)

__all__ = [
    "SCHEMA", "TuneCache", "CACHE", "autotune_mode", "cache_dir",
    "key_sig", "kernel_config", "block_config", "lookup", "put",
    "read_entries", "reload_cache", "summary", "reset_stats",
    "measure", "divisors", "candidate_flash_configs",
    "candidate_matmul_configs", "tune_flash", "tune_matmul_stats",
    "tune_conv_block", "inline_search", "same_config",
    "CostModel", "FEATURES", "featurize", "fit_cost_model",
    "load_model",
]
