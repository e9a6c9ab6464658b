"""Module: one Symbol bound and trained on its contexts.

The counterpart of ``mxnet_tpu/module/module.py``: ``bind`` builds the
executor group (the batch split across the contexts),
``init_params``/``set_params``/``get_params`` move the parameters between
the host copies (``cpu()``) and the devices, ``init_optimizer`` creates
the optimizer with ``rescale_grad = 1 / batch`` (times the workers of a
``dist_sync`` store) and a kvstore or an ``Updater`` (one device and no
``dist`` store need no kvstore), and
``forward``/``backward``/``update`` run the executor and the imperative
update.  ``save_checkpoint``/``load`` write and read the JAX package's
files, the optimizer states included.  ``install_monitor`` hooks a
``Monitor`` into the executor.  A Module bound with ``shared_module=``
takes that module's parameter, gradient and auxiliary arrays, lists its
parameters in that module's order and, once it has one, takes its
optimizer and Updater (``BucketingModule``'s buckets).
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from .. import context as ctx_mod
from .. import io as io_mod
from .. import ndarray as nd
from .. import optimizer as opt_mod
from .. import resilience
from ..context import cpu
from ..initializer import Uniform, InitDesc
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore,
                     load_checkpoint)
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        self._context = context
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        if len(work_load_list) != len(self._context):
            raise ValueError("work_load_list needs one entry a context")
        self._work_load_list = work_load_list
        self._symbol = symbol

        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = list(fixed_param_names) \
            if fixed_param_names is not None else []
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)

        input_names = data_names + label_names + state_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    # --------------------------------------------------------------- static
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a checkpoint; ``kwargs`` go to the constructor
        (``context=`` among them).  Bind it before use."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, when asked,
        ``prefix-%04d.states``, each written whole or not at all, then the
        CRC32 manifest that commits them (the ``checkpoint.save`` seam
        fires before ``.params`` is renamed into place)."""
        resilience.atomic_write("%s-symbol.json" % prefix,
                                self._symbol.save)
        param_name = "%s-%04d.params" % (prefix, epoch)
        resilience.atomic_write(param_name, self.save_params,
                                fault_site="checkpoint.save")
        logging.info("Saved checkpoint to \"%s\"", param_name)
        files = [param_name]
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            resilience.atomic_write(state_name, self.save_optimizer_states)
            logging.info("Saved optimizer state to \"%s\"", state_name)
            files.append(state_name)
        arg_params, aux_params = self.get_params()
        arrays = {("arg:%s" % k): v for k, v in arg_params.items()}
        arrays.update({("aux:%s" % k): v for k, v in aux_params.items()})
        resilience.write_manifest(prefix, epoch, files, arrays=arrays)

    # ----------------------------------------------------------- properties
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._exec_group.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._exec_group.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        shapes = {d.name: d.shape for d in self._data_shapes}
        for d in (self._label_shapes or []):
            shapes[d.name] = d.shape
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, out_shapes))

    # --------------------------------------------------------------- params
    def get_params(self):
        """``(arg_params, aux_params)``: host copies, brought up to date
        from the device after updates."""
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Fill the parameters from ``arg_params``/``aux_params`` or, where
        they have none, from ``initializer`` (drawn on the host in sorted
        name order, as the JAX Module does), and copy them to the
        device."""
        if self.params_initialized and not force_init:
            logging.warning("Parameters already initialized and force_init "
                            "set to False; init_params call ignored.")
            return
        assert self.binded, "call bind before initializing the parameters"

        def fill(desc, arr, cache):
            if cache is not None and desc in cache:
                if cache[desc] is not arr:
                    arr[:] = cache[desc]
                return
            if cache is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % desc)
            if initializer is None:
                return
            host = np.zeros(arr.shape, dtype=np.float32)
            initializer(desc, host)
            arr[:] = host

        if not allow_extra:
            extra = set(arg_params or ()) - set(self._arg_params)
            extra |= set(aux_params or ()) - set(self._aux_params)
            if extra:
                raise ValueError(
                    "set_params/init_params got params not in the module: "
                    "%s (pass allow_extra=True to ignore)" % sorted(extra))
        attrs = self._symbol.attr_dict()
        for name, arr in sorted(self._arg_params.items()):
            fill(InitDesc(name, attrs.get(name)), arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            fill(InitDesc(name, attrs.get(name)), arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            logging.warning("Parameters already initialized and force_init "
                            "set to False; set_params call ignored.")
            return
        self._exec_group.set_params(arg_params, aux_params)
        self._params_dirty = True
        self.params_initialized = True

    # ----------------------------------------------------------------- bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write", strict=False):
        """Bind the executor for these input shapes (``DataDesc``s or
        ``(name, shape)`` pairs).  ``strict=True`` first runs the graph
        verifier (:mod:`mxnet_tpu_torch.analysis`) over the declared data
        and label shapes and raises naming the node before any executor is
        built; ``MXNET_TPU_STRICT_BIND=1`` verifies at the Executor
        instead, at the full bound shapes."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if not for_training and inputs_need_grad:
            raise MXNetError("inputs_need_grad needs for_training")
        data_shapes, label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)
        if strict:
            shapes = {d.name: tuple(d.shape)
                      for d in list(data_shapes) + list(label_shapes or [])}
            self._symbol.verify(shapes=shapes).raise_if_errors(
                "Module.bind strict=True")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes, self._label_shapes = data_shapes, label_shapes
        shared_group = None
        if shared_module is not None:
            if not (isinstance(shared_module, Module)
                    and shared_module.binded
                    and shared_module.params_initialized):
                raise MXNetError("shared_module must be a bound, "
                                 "initialized Module")
            shared_group = shared_module._exec_group
            # the borrowed Updater keys its states by a parameter's position
            # in param_names: list the shared parameters in the shared
            # module's order, any others after them
            order = {n: i for i, n in enumerate(shared_module._param_names)}
            self._param_names = sorted(
                self._param_names, key=lambda n: order.get(n, len(order)))
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            # bound again after the parameters were set: copy them over
            self._exec_group.set_params(self._arg_params, self._aux_params)
        else:
            self._arg_params = {
                n: nd.zeros(x[0].shape, ctx=cpu(), dtype=x[0].data.dtype)
                for n, x in zip(self._param_names,
                                self._exec_group.param_arrays)}
            self._aux_params = {
                n: nd.zeros(x[0].shape, ctx=cpu(), dtype=x[0].data.dtype)
                for n, x in zip(self._aux_names,
                                self._exec_group.aux_arrays)}
        if shared_module is not None and shared_module.optimizer_initialized:
            self.borrow_optimizer(shared_module)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

    # ------------------------------------------------------------ optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer (by name with ``optimizer_params``, gradients
        averaged over the batch, or an instance), and where its updates
        run: a kvstore, or an ``Updater`` here."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        store, on_store = _create_kvstore(kvstore, len(self._context),
                                          self._arg_params)
        # gradients are averaged over the global batch: each worker of a
        # dist_sync job adds its own batch to the sum
        batch = self._exec_group.batch_size
        if store and store.type.startswith("dist") and "_sync" in store.type:
            batch *= store.num_workers
        if isinstance(optimizer, str):
            names = self._exec_group.param_names
            ndev = 1 if on_store else len(self._context)
            slot2name = {i * ndev + k: n
                         for i, n in enumerate(names) for k in range(ndev)}
            kw = dict(optimizer_params)
            kw.setdefault("rescale_grad", 1.0 / batch)
            optimizer = opt_mod.create(optimizer, sym=self.symbol,
                                       param_idx2name=slot2name, **kw)
        else:
            if not isinstance(optimizer, opt_mod.Optimizer):
                raise TypeError("optimizer must be a name or an Optimizer")
            if optimizer.rescale_grad != 1.0 / batch:
                self.logger.warning(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size/"
                    "num_workers (%s vs. %s). Is this intended?",
                    optimizer.rescale_grad, 1.0 / batch)
        self._optimizer = optimizer
        self._kvstore = store
        self._update_on_kvstore = on_store
        if store:
            _initialize_kvstore(kvstore=store,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=on_store)
        if on_store:
            self._updater = None
            store.set_optimizer(optimizer)
        else:
            self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # -------------------------------------------------------------- compute
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        self._exec_group.forward_backward(data_batch)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the gradients: through the kvstore when it updates, else
        the Updater, parameter by parameter."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    # ----------------------------------------------------------- opt states
    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    def install_monitor(self, mon):
        """Hook ``mon`` (a :class:`~mxnet_tpu_torch.monitor.Monitor`) into
        the bound executor."""
        assert self.binded
        self._exec_group.install_monitor(mon)


def _parse_data_desc(data_names, label_names, data_shapes, label_shapes):
    """Shapes as lists of DataDesc, their names checked."""
    data_shapes = [x if isinstance(x, io_mod.DataDesc)
                   else io_mod.DataDesc(*x) for x in data_shapes]
    _check_names_match(data_names, data_shapes, "data", True)
    if label_shapes is not None and len(label_shapes) > 0:
        label_shapes = [x if isinstance(x, io_mod.DataDesc)
                        else io_mod.DataDesc(*x) for x in label_shapes]
        _check_names_match(label_names, label_shapes, "label", False)
    else:
        label_shapes = None
    return data_shapes, label_shapes


def _check_names_match(data_names, data_shapes, name, throw):
    actual = [x[0] for x in data_shapes]
    if sorted(data_names) != sorted(actual):
        msg = "Data provided by %s_shapes don't match names specified by " \
              "%s_names (%s vs. %s)" % (name, name, str(data_shapes),
                                        str(data_names))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)
