"""Checkpoints, the kvstore helpers of the update, and ``FeedForward``.

The counterpart of ``mxnet_tpu/model.py``: ``_create_kvstore`` decides
where updates run, ``_update_params(_on_kvstore)`` push and pull.

``save_checkpoint``/``load_checkpoint`` write and read
``prefix-symbol.json`` and ``prefix-%04d.params`` in the JAX package's
formats.  Each file is written whole or not at all
(:func:`~mxnet_tpu_torch.resilience.atomic_write`), and the checkpoint is
committed by ``prefix-%04d.manifest.json``, written last: each file's size
and CRC32, each array's CRC32, and in ``meta["data_state"]`` the tracked
data iterator's durable state (:mod:`~mxnet_tpu_torch.io_resume`).  The
loader verifies the manifest before it parses ``.params`` and stashes the
data state for the next ``fit``, which resumes mid-epoch;
:func:`find_checkpoints` and :func:`find_latest_checkpoint` pass over
epochs whose files fail it.  Checkpoints and manifests of either package
load and verify in the other.  Parameters load onto the host (``cpu()``);
the Module copies them to its device.
"""
from __future__ import annotations

import glob
import logging
import os
import re
import struct
from collections import namedtuple

import numpy as np

from . import io
from . import io_resume
from . import ndarray as nd
from . import resilience
from . import symbol as sym
from . import kvstore as kvs
from .base import MXNetError
from .context import cpu
from .ndarray import NDArray

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "find_checkpoints", "find_latest_checkpoint",
           "load_latest_checkpoint", "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

#: past this many elements in one parameter, the ``local`` store leaves the
#: update to the workers (the reference's ``MXNET_KVSTORE_BIGARRAY_BOUND``)
_BIGARRAY_BOUND = 1000000


def _create_kvstore(kvstore, num_device, arg_params):
    """``(store or None, update_on_kvstore)``: one device needs no store."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                bound = int(os.environ.get("MXNET_KVSTORE_BIGARRAY_BOUND",
                                           _BIGARRAY_BOUND))
                if max(np.prod(p.shape) for p in arg_params.values()) \
                        > bound:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Init a key per parameter from its initial value."""
    for idx, param_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _grad_pairs(param_arrays, grad_arrays):
    """(index, arg_list, grad_list) of the parameters with a gradient."""
    for index, (arg_list, grad_list) in \
            enumerate(zip(param_arrays, grad_arrays)):
        if grad_list[0] is not None:
            yield index, arg_list, grad_list


def _push_all_bucketed(param_arrays, grad_arrays, kvstore):
    """The overlap prologue of both update paths: push every gradient
    into the store's buckets (each full bucket's all-reduce starts at
    once), then drain at the optimizer boundary."""
    for index, _arg_list, grad_list in _grad_pairs(param_arrays,
                                                   grad_arrays):
        kvstore.push_bucketed(index, grad_list, priority=-index)
    kvstore.drain()


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """Push the gradients, pull the weights the store updated; on a store
    with the overlap path on (``MXNET_TPU_OVERLAP``), every push first,
    one drain, then every pull."""
    if getattr(kvstore, "overlap_active", False):
        _push_all_bucketed(param_arrays, grad_arrays, kvstore)
        for index, arg_list, _g in _grad_pairs(param_arrays, grad_arrays):
            kvstore.pull(index, arg_list, priority=-index)
        return
    for index, arg_list, grad_list in _grad_pairs(param_arrays,
                                                  grad_arrays):
        kvstore.push(index, grad_list, priority=-index)
        kvstore.pull(index, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """Sum the gradients through the store (when there is one), then update
    each device's copy with ``updater``; each copy has its own index, so
    the optimizer keeps a state per device.  The store's sums take the
    overlap path as :func:`_update_params_on_kvstore` does."""
    overlap = kvstore and getattr(kvstore, "overlap_active", False)
    if overlap:
        _push_all_bucketed(param_arrays, grad_arrays, kvstore)
    for index, arg_list, grad_list in _grad_pairs(param_arrays,
                                                  grad_arrays):
        if overlap:
            kvstore.pull(index, grad_list, priority=-index)
        elif kvstore:
            kvstore.push(index, grad_list, priority=-index)
            kvstore.pull(index, grad_list, priority=-index)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` (unless ``symbol`` is None),
    ``prefix-%04d.params`` (``arg:``/``aux:`` names) and, last, the
    manifest, with the tracked iterator's position and durable state in
    its meta.  The ``checkpoint.save`` seam fires between the ``.params``
    write and its rename."""
    if symbol is not None:
        resilience.atomic_write("%s-symbol.json" % prefix, symbol.save)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    resilience.atomic_write(param_name,
                            lambda tmp: nd.save(tmp, save_dict),
                            fault_site="checkpoint.save")
    meta = {}
    pos = io_resume.current_position()
    if pos is not None:
        meta["data_position"] = pos
    entry = io_resume.data_state_entry()
    if entry is not None:
        meta["data_state"] = entry
    resilience.write_manifest(prefix, epoch, [param_name], arrays=save_dict,
                              meta=meta or None)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)``, the parameters on the host.
    Fires the ``checkpoint.load`` seam, verifies the manifest (when there
    is one) before it parses ``.params``, and stashes its data state for
    the next ``fit``; a missing or corrupt file raises an MXNetError
    naming it."""
    resilience.fault_point("checkpoint.load")
    sym_name = "%s-symbol.json" % prefix
    param_name = "%s-%04d.params" % (prefix, epoch)
    manifest = resilience.verify_manifest(prefix, epoch)
    if manifest is not None:
        io_resume.note_loaded_state(
            (manifest.get("meta") or {}).get("data_state"),
            source="%s epoch %d" % (prefix, epoch))
    try:
        symbol = sym.load(sym_name)
    except FileNotFoundError as e:
        raise MXNetError("checkpoint symbol file %r is missing; was "
                         "save_checkpoint(%r, ...) ever run?"
                         % (sym_name, prefix)) from e
    except (ValueError, KeyError) as e:
        raise MXNetError("checkpoint symbol file %r is corrupt: %s"
                         % (sym_name, e)) from e
    try:
        save_dict = nd.load(param_name, ctx=cpu())
    except FileNotFoundError as e:
        raise MXNetError(
            "checkpoint params file %r is missing for epoch %d; available "
            "epochs for this prefix: %s"
            % (param_name, epoch, find_checkpoints(prefix) or "none")) from e
    except (MXNetError, ValueError, struct.error, EOFError) as e:
        raise MXNetError("checkpoint params file %r is corrupt: %s"
                         % (param_name, e)) from e
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


def find_checkpoints(prefix, require_states=False):
    """Sorted epochs with a ``prefix-%04d.params`` on disk (and a
    ``.states`` file when ``require_states``) whose manifest, when there
    is one, screens clean: its files present at their sizes (CRC32 is
    checked by the loader on the epoch it opens)."""
    pat = re.compile(re.escape(prefix) + r"-(\d{4,})\.params$")
    epochs = []
    for f in glob.glob("%s-*.params" % glob.escape(prefix)):
        m = pat.match(f)
        if not m:
            continue
        ep = int(m.group(1))
        if require_states and not os.path.exists(
                "%s-%04d.states" % (prefix, ep)):
            continue
        try:
            resilience.verify_manifest(prefix, ep, quick=True)
        except MXNetError as e:
            logging.warning("skipping unverifiable checkpoint epoch %d "
                            "of %r: %s", ep, prefix, e)
            continue
        epochs.append(ep)
    return sorted(epochs)


def find_latest_checkpoint(prefix, require_states=False):
    """The newest epoch whose manifest passes the full CRC check, passing
    over (and logging) corrupt ones; None when none does."""
    for ep in reversed(find_checkpoints(prefix,
                                        require_states=require_states)):
        try:
            resilience.verify_manifest(prefix, ep)
            return ep
        except MXNetError as e:
            logging.warning("find_latest_checkpoint: skipping "
                            "unverifiable epoch %d of %r: %s",
                            ep, prefix, e)
    return None


def load_latest_checkpoint(prefix, require_states=False):
    """``(epoch, symbol, arg_params, aux_params)`` of the newest checkpoint
    that loads, passing over (and logging) corrupt or incomplete ones;
    raises MXNetError when none loads."""
    failures = []
    for ep in reversed(find_checkpoints(prefix,
                                        require_states=require_states)):
        try:
            symbol, args_, aux_ = load_checkpoint(prefix, ep)
            return ep, symbol, args_, aux_
        except MXNetError as e:
            failures.append("epoch %d: %s" % (ep, e))
            logging.warning("falling back past checkpoint epoch %d of "
                            "%r: %s", ep, prefix, e)
    raise MXNetError(
        "no complete checkpoint found for prefix %r%s"
        % (prefix, " (tried: %s)" % "; ".join(failures)
           if failures else ""))


class FeedForward:
    """The legacy model API, a thin adapter over Module."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform
        from .context import current_context
        self.symbol = symbol
        self.ctx = ctx if isinstance(ctx, (list, tuple)) else \
            [ctx if ctx is not None else current_context()]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None

    def _get_module(self, data_names=("data",),
                    label_names=("softmax_label",)):
        from .module import Module
        if self._module is None:
            label_names = [n for n in label_names
                           if n in self.symbol.list_arguments()]
            self._module = Module(self.symbol, data_names=data_names,
                                  label_names=label_names, context=self.ctx)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        train_data = self._prepare_data(X, y)
        mod = self._get_module(
            data_names=[d.name for d in train_data.provide_data],
            label_names=[d.name for d in train_data.provide_label])
        mod.fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=self.kwargs or {"learning_rate": 0.01},
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()

    def _symbol_label_names(self):
        return [n for n in self.symbol.list_arguments()
                if n.endswith("label")]

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        data = self._prepare_data(X)
        mod = self._get_module(
            data_names=[d.name for d in data.provide_data],
            label_names=self._symbol_label_names())
        if not mod.binded:
            mod.bind(data_shapes=data.provide_data, for_training=False)
            mod.init_params(arg_params=self.arg_params,
                            aux_params=self.aux_params)
        outs = mod.predict(data, num_batch=num_batch)
        return outs.asnumpy() if isinstance(outs, NDArray) else \
            [o.asnumpy() for o in outs]

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        data = self._prepare_data(X)
        mod = self._get_module(
            data_names=[d.name for d in data.provide_data],
            label_names=[d.name for d in data.provide_label])
        if not mod.binded:
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label, for_training=False)
            mod.init_params(arg_params=self.arg_params,
                            aux_params=self.aux_params)
        return mod.score(data, eval_metric, num_batch=num_batch)[0][1]

    def _prepare_data(self, X, y=None):
        if isinstance(X, io.DataIter):
            return X
        return io.NDArrayIter(X, y, batch_size=self.numpy_batch_size)

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, self.num_epoch if epoch is None else epoch,
                        self.symbol, self.arg_params, self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
