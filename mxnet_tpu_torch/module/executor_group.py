"""DataParallelExecutorGroup: one executor a context, the batch split.

The counterpart of ``mxnet_tpu/module/executor_group.py`` (the
reference's ``executor_group.py``): ``decide_slices`` splits the batch
across the contexts by ``workload``; each context binds its own executor
(parameters, gradients, auxiliary states and input arrays on its device,
grad_req per argument); each batch is copied slice by slice into the
input arrays; outputs and input gradients are concatenated along the
batch axis; the metric is updated context by context with the label
slices.  The gradients of the contexts are summed by the kvstore (or
``model._update_params``), as in JAX; BatchNorm reduces each context's
own rows, the reference's per-device semantics.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..base import MXNetError
from .. import io as io_mod
from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["DataParallelExecutorGroup"]


def _rows(src, start, stop):
    """Rows ``[start, stop)`` of a batch array (NDArray, tensor or
    numpy)."""
    if isinstance(src, NDArray):
        return NDArray(src.data[start:stop])
    return np.asarray(src)[start:stop]


def _load_general(data, targets):
    """Copy a batch's arrays into the bound input arrays: ``targets`` holds
    each entry's ``[(slice, array)]`` a context (None: an entry the symbol
    does not take)."""
    for src, dst in zip(data, targets):
        if dst is None:
            continue
        if len(dst) == 1:
            dst[0][1][:] = src
            continue
        for sl, arr in dst:
            arr[:] = _rows(src, sl.start, sl.stop)


def _merge_multi_context(outputs, major_axis):
    """Each output's per-context tensors concatenated along the batch
    axis, on the first context's device."""
    rets = []
    for tensors, axis in zip(outputs, major_axis):
        if axis >= 0 and len(tensors) > 1:
            dev = tensors[0].data.device
            rets.append(NDArray(torch.cat(
                [t.data.to(dev) for t in tensors], dim=axis)))
        else:
            rets.append(tensors[0])
    return rets


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes,
                 label_shapes, param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None):
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1] * len(contexts)
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
            if shared_group is not None else [{} for _ in contexts]
        self.output_layouts = [io_mod.DataDesc.get_batch_axis("NCHW")
                               for _ in symbol.list_outputs()]
        self.batch_size = None
        self.slices = None
        self.execs = []
        self.data_shapes = None
        self.label_shapes = None
        self.data_layouts = None
        self.label_layouts = None
        self.param_arrays = None
        self.grad_arrays = None
        self.aux_arrays = None
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def decide_slices(self, shapes):
        """The batch axis of each entry, and (at the first entry with one)
        the contexts' slices of the batch, weighted by ``workload``."""
        major_axis = [io_mod.DataDesc.get_batch_axis(
            getattr(d, "layout", "NCHW")) for d in shapes]
        for desc, axis in zip(shapes, major_axis):
            if axis < 0:
                continue
            size = desc.shape[axis]
            if self.batch_size is not None:
                if size != self.batch_size:
                    raise MXNetError(
                        "all data must have the same batch size: "
                        "batch_size = %d, but %s has shape %s"
                        % (self.batch_size, desc.name, desc.shape))
                continue
            self.batch_size = size
            total = sum(self.workload)
            self.slices, start = [], 0
            for k, w in enumerate(self.workload):
                end = size if k == len(self.workload) - 1 else \
                    start + int(round(size * w / total))
                self.slices.append(slice(start, end))
                start = end
        return major_axis

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        self.batch_size = None
        self.data_layouts = self.decide_slices(data_shapes)
        if label_shapes is not None:
            self.label_layouts = self.decide_slices(label_shapes)
        # a reshape keeps the parameters, their grads and the aux states
        shared = self.execs if reshape else \
            None if shared_group is None else shared_group.execs
        self.execs = [self._bind_ith_exec(
            i, data_shapes, label_shapes,
            None if shared is None else shared[i])
            for i in range(len(self.contexts))]
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.param_arrays = [[e.arg_dict[n] for e in self.execs]
                             for n in self.param_names]
        self.grad_arrays = [[e.grad_dict.get(n) for e in self.execs]
                            for n in self.param_names] \
            if self.for_training else None
        self.aux_arrays = [[e.aux_dict[n] for e in self.execs]
                           for n in self.aux_names]

    def _sliced(self, shapes, i, major_axis):
        """The descriptors of context ``i``'s slice."""
        out = []
        for desc, axis in zip(shapes, major_axis):
            shape = list(desc.shape)
            if axis >= 0:
                shape[axis] = self.slices[i].stop - self.slices[i].start
            out.append(io_mod.DataDesc(desc.name, tuple(shape),
                                       getattr(desc, "dtype", np.float32)))
        return out

    def _bind_ith_exec(self, i, data_shapes, label_shapes, shared_exec):
        """Context ``i``'s executor: parameters (and their grads) new or
        shared with ``shared_exec``, inputs from the context's pool by
        name and shape."""
        context = self.contexts[i]
        pool = self.shared_data_arrays[i]
        descs = self._sliced(data_shapes, i, self.data_layouts)
        if label_shapes is not None:
            descs += self._sliced(label_shapes, i, self.label_layouts)
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
        """The contexts' parameters and aux states, averaged, into the
        given (host) arrays (with one context, its arrays as they are)."""
        for names, blocks, dst in ((self.param_names, self.param_arrays,
                                    arg_params),
                                   (self.aux_names, self.aux_arrays,
                                    aux_params)):
            for name, block in zip(names, blocks):
                if len(block) == 1:
                    dst[name][:] = block[0]
                else:
                    dst[name][:] = sum(w.asnumpy() for w in block) \
                        / len(block)

    @property
    def data_arrays(self):
        return [[(self.slices[i], e.arg_dict[x.name])
                 for i, e in enumerate(self.execs)]
                for x in self.data_shapes]

    @property
    def label_arrays(self):
        # labels the symbol does not take (an inference symbol scored with
        # a labelled iterator) are None, keeping the batch's order
        return [None if x.name not in self.execs[0].arg_dict else
                [(self.slices[i], e.arg_dict[x.name])
                 for i, e in enumerate(self.execs)]
                for x in self.label_shapes]

    def _load_batch(self, data_batch):
        _load_general(data_batch.data, self.data_arrays)
        if self.label_shapes is not None and data_batch.label:
            _load_general(data_batch.label, self.label_arrays)

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
        for i, exe in enumerate(self.execs):
            if out_grads is None or len(self.execs) == 1:
                exe.backward(out_grads=out_grads)
                continue
            sl = self.slices[i]
            exe.backward(out_grads=[
                _rows(g, sl.start, sl.stop) if axis >= 0 else g
                for g, axis in zip(out_grads, self.output_layouts)])

    def get_outputs(self, merge_multi_context=True):
        outputs = [[e.outputs[i] for e in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return _merge_multi_context(outputs, self.output_layouts)
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True")
        grads = [[e.grad_dict[x.name] for e in self.execs]
                 for x in self.data_shapes]
        if merge_multi_context:
            return _merge_multi_context(grads, self.data_layouts)
        return grads

    def update_metric(self, eval_metric, labels):
        """The metric updated context by context, each with its slice of
        the labels."""
        if len(self.execs) == 1:
            eval_metric.update(labels, self.execs[0].outputs)
            return
        layouts = self.label_layouts or [0] * len(labels)
        for exe, sl in zip(self.execs, self.slices):
            eval_metric.update(
                [_rows(lab, sl.start, sl.stop) if axis == 0 else lab
                 for lab, axis in zip(labels, layouts)], exe.outputs)

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)
