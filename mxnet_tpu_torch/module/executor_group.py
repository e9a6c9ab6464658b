"""DataParallelExecutorGroup on one context.

The counterpart of ``mxnet_tpu/module/executor_group.py``: it binds the
executor (parameters, gradients, auxiliary states and input arrays on the
context's device, grad_req per argument), copies each batch into the input
arrays, and hands outputs and labels to the metric.  Several contexts (the
batch split across GPUs) are ROADMAP Queue A item 6 and raise.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from .. import io as io_mod
from .. import ndarray as nd

__all__ = ["DataParallelExecutorGroup"]


def _load(arrays, targets):
    """Copy a batch's arrays into the bound input arrays (None: an entry the
    symbol does not take)."""
    for src, dst in zip(arrays, targets):
        if dst is not None:
            dst[:] = src


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes,
                 label_shapes, param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None):
        if len(contexts) != 1:
            raise MXNetError(
                "DataParallelExecutorGroup: %d contexts; the port binds one "
                "(several GPUs are ROADMAP Queue A item 6, multi-GPU and "
                "distribution)" % len(contexts))
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = fixed_param_names or []

        if not for_training:
            grad_req = "null"
        data_names = [x.name for x in data_shapes]
        if isinstance(grad_req, str):
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = "null" \
                        if k in self.fixed_param_names else grad_req
                elif k in data_names:
                    self.grad_req[k] = grad_req if inputs_need_grad \
                        else "null"
                else:
                    self.grad_req[k] = "null"
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self.grad_req = {k: "null" for k in self.arg_names}
            self.grad_req.update(grad_req)
        else:
            raise ValueError("invalid grad_req")

        self.shared_data_arrays = shared_group.shared_data_arrays \
            if shared_group is not None else [{}]
        self.batch_size = None
        self.execs = []
        self.data_shapes = None
        self.label_shapes = None
        self.param_arrays = None
        self.grad_arrays = None
        self.aux_arrays = None
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def _batch_size(self, shapes):
        for desc in shapes:
            axis = io_mod.DataDesc.get_batch_axis(getattr(desc, "layout",
                                                          "NCHW"))
            if axis < 0:
                continue
            size = desc.shape[axis]
            if self.batch_size is None:
                self.batch_size = size
            elif size != self.batch_size:
                raise MXNetError("all data must have the same batch size: "
                                 "batch_size = %d, but %s has shape %s"
                                 % (self.batch_size, desc.name, desc.shape))

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        self.batch_size = None
        self._batch_size(data_shapes)
        if label_shapes is not None:
            self._batch_size(label_shapes)
        # a reshape keeps the parameters, their grads and the aux states
        shared_exec = self.execs[0] if reshape else \
            None if shared_group is None else shared_group.execs[0]
        self.execs = [self._bind_exec(data_shapes, label_shapes,
                                      shared_exec)]
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        exe = self.execs[0]
        self.param_arrays = [[exe.arg_dict[n]] for n in self.param_names]
        self.grad_arrays = [[exe.grad_dict.get(n)] for n in self.param_names] \
            if self.for_training else None
        self.aux_arrays = [[exe.aux_dict[n]] for n in self.aux_names]

    def _bind_exec(self, data_shapes, label_shapes, shared_exec):
        """The executor: parameters (and their grads) new or shared with
        ``shared_exec``, inputs from the shared pool by name and shape."""
        context = self.contexts[0]
        pool = self.shared_data_arrays[0]
        descs = list(data_shapes) + list(label_shapes or [])
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(
            **{d.name: tuple(d.shape) for d in descs})
        arg_types, _, aux_types = self.symbol.infer_type(
            **{d.name: getattr(d, "dtype", np.float32) for d in descs})

        def pooled(name, shape, dtype):
            arr = pool.get(name)
            if arr is None or tuple(arr.shape) != tuple(shape):
                arr = nd.zeros(shape, ctx=context, dtype=dtype)
                pool[name] = arr
            return arr

        args, grads = [], {}
        for name, shape, dtype in zip(self.arg_names, arg_shapes, arg_types):
            need_grad = self.grad_req[name] != "null"
            if name in self.param_names:
                if shared_exec is None:
                    arr = nd.zeros(shape, ctx=context, dtype=dtype)
                    if need_grad:
                        grads[name] = nd.zeros(shape, ctx=context,
                                               dtype=dtype)
                else:
                    arr = shared_exec.arg_dict[name]
                    if tuple(arr.shape) != tuple(shape):
                        raise MXNetError("shared parameter %r has shape %s, "
                                         "want %s" % (name, arr.shape, shape))
                    if need_grad:
                        grads[name] = shared_exec.grad_dict[name]
            else:
                arr = pooled(name, shape, dtype)
                if need_grad:
                    grads[name] = pooled("grad of " + name, shape, dtype)
            args.append(arr)
        aux = shared_exec.aux_arrays[:] if shared_exec is not None else \
            [nd.zeros(s, ctx=context, dtype=t)
             for s, t in zip(aux_shapes, aux_types)]
        return self.symbol.bind(ctx=context, args=args, args_grad=grads,
                                aux_states=aux, grad_req=self.grad_req)

    def reshape(self, data_shapes, label_shapes):
        if data_shapes == self.data_shapes and \
                label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes, reshape=True)

    def set_params(self, arg_params, aux_params):
        for exe in self.execs:
            exe.copy_params_from(arg_params, aux_params,
                                 allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """Copy the device's parameters into the given (host) arrays."""
        for name, block in zip(self.param_names, self.param_arrays):
            arg_params[name][:] = block[0]
        for name, block in zip(self.aux_names, self.aux_arrays):
            aux_params[name][:] = block[0]

    @property
    def data_arrays(self):
        return [self.execs[0].arg_dict[x.name] for x in self.data_shapes]

    @property
    def label_arrays(self):
        # labels the symbol does not take (an inference symbol scored with
        # a labelled iterator) are skipped, keeping the batch's order
        return [self.execs[0].arg_dict.get(x.name)
                for x in self.label_shapes]

    def _load_batch(self, data_batch):
        _load(data_batch.data, self.data_arrays)
        if self.label_shapes is not None and data_batch.label:
            _load(data_batch.label, self.label_arrays)

    def forward(self, data_batch, is_train=None):
        self._load_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        for exe in self.execs:
            exe.forward(is_train=is_train)

    def forward_backward(self, data_batch):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True")
        self._load_batch(data_batch)
        for exe in self.execs:
            exe.forward_backward()

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True")
        for exe in self.execs:
            exe.backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        outputs = [[out] for out in self.execs[0].outputs]
        return [o[0] for o in outputs] if merge_multi_context else outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True")
        grads = [[self.execs[0].grad_dict[x.name]] for x in self.data_shapes]
        return [g[0] for g in grads] if merge_multi_context else grads

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.execs[0].outputs)

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)
