"""BucketingModule: inputs of several lengths, one executor a length,
one parameter set.

The counterpart of ``mxnet_tpu/module/bucketing_module.py``.
``sym_gen(bucket_key) -> (symbol, data_names, label_names)`` gives each
bucket's graph; ``bind`` binds the default bucket's ``Module`` and
``switch_bucket`` binds every other bucket's once, with ``shared_module=``
the default bucket's, so that all buckets train the same parameter,
gradient and auxiliary arrays and, through ``borrow_optimizer``, the same
optimizer and ``Updater`` (one optimizer state a parameter).  A bucket met
again reuses its executor: the binds are bounded by the bucket count.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise ValueError("BucketingModule needs a default_bucket_key")
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._state_names = state_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    # ----------------------------------------------------------- properties
    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    # --------------------------------------------------------------- params
    def get_params(self):
        assert self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            return
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init)
        self._params_dirty = False
        self.params_initialized = True

    # ----------------------------------------------------------------- bind
    def _new_module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      work_load_list=self._work_load_list,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's module."""
        if shared_module is not None:
            raise MXNetError("shared_module for BucketingModule is not "
                             "supported")
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        module = self._new_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, shared_module=None,
                    grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module the current one, binding it first
        (sharing the default bucket's arrays and optimizer) when it is
        new."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            module = self._new_module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False, shared_module=default)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    # ------------------------------------------------------------ optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The current module makes the optimizer; every other bucket
        borrows it (buckets bound later borrow it at bind)."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    # -------------------------------------------------------------- compute
    def prepare(self, data_batch):
        """Bind ``data_batch``'s bucket ahead of its forward, keeping the
        current bucket."""
        assert self.binded and self.params_initialized
        original_bucket_key = self._curr_bucket_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self.switch_bucket(original_bucket_key, None, None)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def forward_backward(self, data_batch):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward_backward(data_batch)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    # ------------------------------------------------------------- utility
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """The default bucket's symbol and the shared parameters (and the
        optimizer states), as ``Module.save_checkpoint`` writes them."""
        assert self.binded and self.params_initialized
        self.get_params()           # the current values off the device
        default = self._buckets[self._default_bucket_key]
        default._params_dirty = False
        default.save_checkpoint(prefix, epoch, save_optimizer_states)

    def install_monitor(self, mon):
        """Hook ``mon`` into every bucket bound so far."""
        assert self.binded
        for mod in self._buckets.values():
            mod.install_monitor(mon)
