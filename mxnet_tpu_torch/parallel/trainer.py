"""ShardedTrainer: a loss-headed Symbol trained step by step on one device.

The counterpart of ``mxnet_tpu/parallel/trainer.py``.  The JAX trainer jits
forward, vjp and optimizer update into one XLA program over a mesh; here
the same step runs eagerly in PyTorch on the mesh's one device:

* f32 master weights are cast to the compute dtype (bf16 training) as the
  graph's view of them, and ``eval_graph`` runs with ``is_train=True`` under
  autograd; the flash-attention op reaches the CUDA kernels forward and
  backward through ``FlashAttention``;
* ``torch.autograd.backward`` on the loss heads, with ones as their
  gradient (the JAX step's vjp cotangent), gives f32 gradients of the
  masters;
* the fused update rule of the optimizer (``_make_update_rule``) runs under
  ``torch.no_grad()``, **in place** on the f32 masters and the optimizer
  slots, with ``rescale_grad`` (default 1/global batch) and the reference's
  lr_mult/wd_mult;
* BatchNorm's moving statistics (the aux state) come back from
  ``eval_graph`` as aux updates and are written into ``self.aux`` in f32
  after each step's backward, as the JAX step returns ``new_aux``;
* the monitoring loss is mean -log p(label) of the softmax head, with the
  label clipped into range.

``layout="NHWC"`` runs the graph under ``image_layout("NHWC")``: image
activations are channel-minor end to end, ``put_batch`` transposes NCHW
host images on the device, and 4-d weights keep their OIHW shape in
``channels_last`` memory format in the compute view, which is what cuDNN
reads for an NHWC convolution.  ``fuse_blocks=True`` runs it under
``block_fusion(True)``: conv->BN->ReLU chains become single regions, and
the 1x1 ones take K5 (``ops.fused.matmul_stats``); ``fuse_blocks=None``
reads ``MXNET_FUSE_BLOCKS``, as the JAX trainer does.  ``input_mean`` and
``input_std`` normalize uint8 data batches on the device, after their
bytes land: ``put_batch`` casts them to f32, subtracts the mean, divides by
the std and casts to the compute dtype (the native pipeline's
``raw_uint8`` batches, which move a quarter of the bytes of f32 images).

Dropout draws from one ``torch.Generator`` per trainer, seeded from
``seed``; initial weights come from ``numpy.random.RandomState(seed)``.
Telemetry, numerics, resilience and checkpoints are not yet ported, nor are
the JAX trainer's TPU-era rewrites and kinds of parallelism: setting one
raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..initializer import InitDesc, Xavier
from ..ops.fused import block_fusion, block_fusion_enabled
from ..ops.nn import NHWC_UNAWARE_OPS, image_layout
from ..symbol import _classify_vars, eval_graph
from ..analysis import fusion as _fusion
from .. import optimizer as _opt_mod

__all__ = ["ShardedTrainer"]


def _make_update_rule(opt):
    """``(n_state_slots, rule)`` for the optimizer's update.

    ``rule(w, g, slots, lr, wd, t)`` updates the f32 master ``w`` and its
    ``slots`` in place from the rescaled f32 gradient ``g``; ``t`` is the
    1-based update count (Adam's bias correction).  The arithmetic is the
    JAX trainer's, step for step."""
    clip = opt.clip_gradient

    def clipped(g):
        return g.clamp(-clip, clip) if clip is not None and clip > 0 else g

    def prep(g, w, wd):
        return clipped(g) + wd * w

    name = type(opt).__name__.lower()

    if name in ("sgd", "ccsgd"):
        momentum = opt.momentum
        if momentum == 0.0:
            def sgd_rule(w, g, s, lr, wd, t):
                w.sub_(lr * prep(g, w, wd))
            return 0, sgd_rule

        def sgd_mom_rule(w, g, s, lr, wd, t):
            s[0].mul_(momentum).sub_(lr * prep(g, w, wd))
            w.add_(s[0])
        return 1, sgd_mom_rule

    if name == "nag":
        momentum = opt.momentum

        def nag_rule(w, g, s, lr, wd, t):
            g = prep(g, w, wd)
            s[0].mul_(momentum).add_(g)
            w.sub_(lr * (g + momentum * s[0]))
        return 1, nag_rule

    if name == "adam":
        b1, b2, eps = opt.beta1, opt.beta2, opt.epsilon

        def adam_rule(w, g, s, lr, wd, t):
            g = prep(g, w, wd)
            s[0].mul_(b1).add_((1 - b1) * g)
            s[1].mul_(b2).add_((1 - b2) * g.square())
            lr_t = lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
            w.sub_(lr_t * s[0] / (s[1].sqrt() + eps))
        return 2, adam_rule

    if name == "adagrad":
        eps = opt.float_stable_eps

        def adagrad_rule(w, g, s, lr, wd, t):
            g = clipped(g)
            s[0].add_(g.square())
            w.sub_(lr * (g / (s[0] + eps).sqrt() + wd * w))
        return 1, adagrad_rule

    if name == "rmsprop" and not getattr(opt, "centered", False):
        g1, eps = opt.gamma1, opt.epsilon

        def rmsprop_rule(w, g, s, lr, wd, t):
            g = prep(g, w, wd)
            s[0].copy_((1 - g1) * g.square() + g1 * s[0])
            w.sub_(lr * g / (s[0] + eps).sqrt())
        return 1, rmsprop_rule

    if name == "adadelta":
        rho, eps = opt.rho, opt.epsilon

        def adadelta_rule(w, g, s, lr, wd, t):
            g = clipped(g)
            s[0].copy_(rho * s[0] + (1 - rho) * g.square())
            delta = (s[1] + eps).sqrt() / (s[0] + eps).sqrt() * g
            s[1].copy_(rho * s[1] + (1 - rho) * delta.square())
            w.copy_(w - delta - wd * w)
        return 2, adadelta_rule

    raise MXNetError(
        "optimizer %r has no fused ShardedTrainer formulation; supported: "
        "sgd, ccsgd, nag, adam, adagrad, rmsprop (non-centered), adadelta"
        % name)


# data inputs consumed as integer indices, and the shape-only ops an index
# input may pass through on its way there (the JAX trainer's tables)
_INDEX_ARG_OF = {"Embedding": 0, "one_hot": 0, "take": 1, "gather_nd": 1,
                 "batch_take": 1}
_PASS_THROUGH = frozenset({
    "Reshape", "Flatten", "expand_dims", "transpose", "BlockGrad",
    "slice_axis", "slice", "identity", "stop_gradient", "SwapAxis",
    "squeeze"})
# ops of the port adapted to NHWC activations: their channel axis is
# remapped while the graph runs, so an explicit axis attr is fine
_NHWC_ADAPTED = frozenset({
    "Convolution", "Pooling", "BatchNorm", "Flatten", "FullyConnected",
    "Activation", "Dropout", "SoftmaxOutput"})


class ShardedTrainer:
    def __init__(self, symbol, mesh, data_shapes, label_shapes=(),
                 optimizer="sgd", optimizer_params=None, learning_rate=0.05,
                 momentum=0.9, weight_decay=0.0, initializer=None,
                 dtype="float32", tp_rules=None, seed=0, layout=None,
                 auto_layouts=False, fuse_conv_bn=None, fuse_blocks=None,
                 stem_space_to_depth=None, elide_input_bn_grad=True,
                 strided_bwd_phase=None, pipeline_stages=1,
                 pipeline_microbatches=None, sequence_parallel=False,
                 input_mean=None, input_std=None, conv1x1_as_dot=None,
                 native_weight_layout=None, strict=None):
        """
        symbol: loss-headed Symbol (e.g. a SoftmaxOutput net).
        mesh: a one-device mesh from :func:`build_mesh`; state lives on its
            device (``gpu(0)`` unless the mesh was built on ``mx.cpu()``).
        data_shapes/label_shapes: dict name -> global shape (batch dim 0).
        optimizer: registry name or an Optimizer instance (see
            :func:`_make_update_rule` for the supported set);
            ``learning_rate``/``momentum``/``weight_decay`` are defaults
            merged into ``optimizer_params``.
        initializer: default Xavier(gaussian, in, 2) drawing from
            ``numpy.random.RandomState(seed)``.
        dtype: compute dtype of activations and gradients; masters stay f32.
        seed: seeds the initial weights and the trainer's Dropout generator.
        layout: None or "NCHW" (the reference's), or "NHWC" (channel-minor
            image activations; host batches stay NCHW and are transposed
            on the device).  Weights keep their reference shapes.
        fuse_blocks: run the block-fusion plan (analysis.fusion) in the
            step and the forward; None means ``MXNET_FUSE_BLOCKS`` decides
            (off unless it is 1).
        input_mean/input_std: per-channel sequences (or scalars) applied
            on the device to uint8 data inputs staged by
            :meth:`put_batch`: ``(x - mean) / std`` in f32 (as the f32
            reciprocal), then the compute dtype.  Other uint8 inputs, and any input when both are None,
            reach the graph unchanged.
        auto_layouts: XLA-chosen state layouts, which have no counterpart
            in eager PyTorch; only the default False is accepted.
        elide_input_bn_grad: gradients are taken with respect to parameters
            only, never batch inputs; only the default True is accepted.
        fuse_conv_bn, stem_space_to_depth, strided_bwd_phase,
        conv1x1_as_dot, pipeline_stages > 1,
        sequence_parallel, tp_rules, native_weight_layout, strict: not
        yet ported; setting one raises (None means off, there being no
        environment defaults for them here).
        """
        if auto_layouts or not elide_input_bn_grad:
            raise MXNetError(
                "ShardedTrainer: auto_layouts=True and "
                "elide_input_bn_grad=False have no counterpart in "
                "mxnet_tpu_torch (eager PyTorch; gradients of parameters "
                "only)")
        if layout not in (None, "NCHW", "NHWC"):
            raise MXNetError("unsupported layout %r" % (layout,))
        unported = {
            "fuse_conv_bn": bool(fuse_conv_bn),
            "stem_space_to_depth": bool(stem_space_to_depth),
            "strided_bwd_phase": bool(strided_bwd_phase),
            "conv1x1_as_dot": bool(conv1x1_as_dot),
            "pipeline_stages=%r" % (pipeline_stages,): pipeline_stages != 1,
            "sequence_parallel": bool(sequence_parallel),
            "tp_rules": tp_rules is not None,
            "native_weight_layout": bool(native_weight_layout),
            "strict": bool(strict),
        }
        bad = [k for k, on in unported.items() if on]
        if bad:
            raise MXNetError("ShardedTrainer: %s not yet ported to "
                             "mxnet_tpu_torch" % ", ".join(bad))

        self.symbol = symbol
        self.mesh = mesh
        self.dtype = dtype
        self._device = mesh.device
        self._compute_dtype = torch_dtype(dtype)
        self._layout = layout or "NCHW"
        if fuse_blocks is None:
            fuse_blocks = block_fusion_enabled()
        self._fuse_blocks = bool(fuse_blocks)
        self._input_mean = input_mean
        self._input_std = input_std
        self._input_stats = {}
        self._topo = symbol._topo()
        if self._layout == "NHWC":
            self._check_nhwc_safe()
        self._arg_nodes, self._aux_nodes = _classify_vars(self._topo)
        arg_names = [n.name for n in self._arg_nodes]
        self._input_names = list(data_shapes) + list(label_shapes or ())
        self._data_names = list(data_shapes)
        self._label_shapes = dict(label_shapes or {})
        self._param_names = [n for n in arg_names
                             if n not in self._input_names]
        self._aux_names = [n.name for n in self._aux_nodes]
        self._head_is_loss = [bool(n.op is not None and n.op.is_loss)
                              for (n, _i) in symbol._entries]
        self._int_inputs = self._index_inputs()

        # inputs whose activations move to channel-minor under NHWC
        self._nhwc_inputs = {n for n, s in data_shapes.items()
                             if self._layout == "NHWC" and len(s) == 4}
        self._host_input_shapes = {n: tuple(s)
                                   for n, s in data_shapes.items()}
        shapes = {n: (s[0], s[2], s[3], s[1]) if n in self._nhwc_inputs
                  else tuple(s) for n, s in data_shapes.items()}
        shapes.update({n: tuple(s) for n, s in self._label_shapes.items()})
        self._input_shapes = shapes
        with image_layout(self._layout):
            arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        self._arg_shapes = dict(zip(arg_names, arg_shapes))
        self._aux_shapes = dict(zip(self._aux_names, aux_shapes))
        global_batch = next(iter(data_shapes.values()))[0]

        # ---- optimizer: registry-created, reference mult semantics
        if isinstance(optimizer, str):
            kw = dict(optimizer_params or {})
            kw.setdefault("learning_rate", learning_rate)
            kw.setdefault("wd", weight_decay)
            if optimizer.lower() in ("sgd", "ccsgd", "nag", "dcasgd"):
                kw.setdefault("momentum", momentum)
            kw.setdefault("rescale_grad", 1.0 / global_batch)
            kw.setdefault("param_idx2name",
                          {n: n for n in self._param_names})
            optimizer = _opt_mod.create(optimizer, **kw)
        else:
            # as Module.init_optimizer: default rescale to gradient
            # averaging, and give the mult machinery the param names
            if optimizer.rescale_grad == 1.0:
                optimizer.rescale_grad = 1.0 / global_batch
            if not optimizer.idx2name:
                optimizer.idx2name = {n: n for n in self._param_names}
                optimizer.set_lr_mult({})
                optimizer.set_wd_mult({})
        self.optimizer = optimizer
        self._n_slots, self._update_rule = _make_update_rule(optimizer)

        # ---- f32 masters, initialized on the host, moved to the device
        init = initializer or Xavier(rnd_type="gaussian", factor_type="in",
                                     magnitude=2,
                                     rng=np.random.RandomState(seed))
        self.params = {}
        for name in self._param_names:
            arr = np.zeros(self._arg_shapes[name], np.float32)
            init(InitDesc(name), arr)
            self.params[name] = torch.from_numpy(arr).to(self._device)
        self.aux = {}
        for name in self._aux_names:
            fill = 1.0 if name.endswith("moving_var") else 0.0
            self.aux[name] = torch.full(self._aux_shapes[name], fill,
                                        dtype=torch.float32,
                                        device=self._device)
        self.opt_state = self._zero_slots()
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        self._step_count = 0

    def _check_nhwc_safe(self):
        """Refuse NHWC for graphs whose ops would silently index the wrong
        axis: channel-axis ops with no NHWC adaptation, and other ops that
        pin an explicit axis that could be spatial or channel (axis attrs
        are written against the reference NCHW convention)."""
        bad = set()
        for node in self._topo:
            if node.op is None:
                continue
            name = node.op.name
            if name in NHWC_UNAWARE_OPS:
                bad.add(name)
                continue
            if name in _NHWC_ADAPTED:
                continue
            if name == "transpose" and not node.attrs.get("axes"):
                bad.add("transpose()")  # default axes reverse all dims
                continue
            for key in ("axis", "dim", "axes", "begin", "end"):
                v = node.attrs.get(key)
                vals = v if isinstance(v, (tuple, list)) else (v,)
                if any(isinstance(x, int) and
                       (1 <= x <= 3 or -3 <= x <= -1) for x in vals):
                    bad.add("%s(%s=%r)" % (name, key, v))
                    break
        if bad:
            raise MXNetError(
                "layout='NHWC' is not supported for graphs containing %s: "
                "these index axes in the reference NCHW convention and "
                "have no NHWC adaptation; use the default NCHW layout"
                % ", ".join(sorted(bad)))

    def _index_inputs(self):
        """Data inputs consumed as integer indices (Embedding/take/...),
        followed through shape-only ops: these are never cast to a narrow
        compute dtype, since bf16 rounds ids above 256."""
        carriers = {id(n): n.name for n in self._arg_nodes
                    if n.name in self._data_names}
        found = set()
        for node in self._topo:
            if node.op is None:
                continue
            if node.op.name in _PASS_THROUGH and node.inputs:
                src = node.inputs[0][0]
                if id(src) in carriers:
                    carriers[id(node)] = carriers[id(src)]
            idx = _INDEX_ARG_OF.get(node.op.name)
            if idx is None or idx >= len(node.inputs):
                continue
            nm = carriers.get(id(node.inputs[idx][0]))
            if nm is not None:
                found.add(nm)
        return found

    def _zero_slots(self):
        return {n: [torch.zeros_like(w) for _ in range(self._n_slots)]
                for n, w in self.params.items()}

    def _refresh_rule(self):
        """Rebuild the update rule from the optimizer's current attributes,
        as the JAX trainer recompiles when they change; a rule with another
        number of slots starts from zeroed slots."""
        n_slots, self._update_rule = _make_update_rule(self.optimizer)
        if n_slots != self._n_slots:
            self._n_slots = n_slots
            self.opt_state = self._zero_slots()

    # ---------------------------------------------------------------- batches
    def put_batch(self, batch):
        """Stage a host batch (numpy arrays or tensors, global batch dim,
        images in the reference NCHW convention) on the trainer's device in
        the dtypes and layout the step takes: data inputs in the compute
        dtype; labels and index inputs (token ids) in float32, which is
        exact for ids below 2^24.  Under ``layout="NHWC"`` an image batch
        is transposed on the device, after its host bytes land (a raw NHWC
        uint8 batch is already in the step's layout); under NCHW a raw
        NHWC uint8 data batch (the native iterators' ``raw_uint8``) is
        permuted to NCHW there.  A uint8 data batch is then normalized
        there by ``input_mean``/``input_std`` when the trainer has them:
        ``(x - mean) * (1 / std)`` in f32, the JAX staging program's
        arithmetic to the bit.  A pinned host tensor is copied without
        blocking, on the current stream.  Reuse the result across
        :meth:`step` calls to move it once."""
        out = {}
        normalize = (self._input_mean is not None
                     or self._input_std is not None)
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(v))
            t = t.to(self._device, non_blocking=True)
            # the batch dim may differ (a partial tail batch): compare the
            # feature dims only.  A batch that also reads as NHWC (C == H
            # == W) follows the documented NCHW host convention.
            feat = tuple(t.shape[1:])
            transpose = k in self._nhwc_inputs and t.dim() == 4 and (
                feat != tuple(self._input_shapes[k][1:])
                or feat == tuple(self._host_input_shapes[k][1:]))
            if transpose:
                t = t.permute(0, 2, 3, 1).contiguous()
            elif t.dtype == torch.uint8 and k in self._data_names \
                    and t.dim() == 4 == len(self._input_shapes[k]):
                c, h, w = self._input_shapes[k][1:]
                if feat != (c, h, w) and feat == (h, w, c):
                    t = t.permute(0, 3, 1, 2).contiguous()
            if t.dtype == torch.uint8 and k in self._data_names \
                    and normalize:
                ch_axis = -1 if (self._layout == "NHWC" or transpose) \
                    else 1
                t = t.float()
                if self._input_mean is not None:
                    t = t - self._input_stat("mean", ch_axis, t.dim())
                if self._input_std is not None:
                    # times the f32 reciprocal: the JAX staging program's
                    # division by a constant, as XLA compiles it
                    t = t * self._input_stat("std", ch_axis, t.dim())
                t = t.to(self._compute_dtype)
            elif t.is_floating_point():
                if "label" not in k and k not in self._int_inputs:
                    t = t.to(self._compute_dtype)
                elif t.dtype == torch.float64:
                    t = t.float()
            out[k] = t
        return out

    def _input_stat(self, which, ch_axis, ndim):
        """``input_mean``, or the reciprocal of ``input_std`` (``"std"``),
        as an f32 tensor on the device, shaped to broadcast along the
        channel axis; made once a shape."""
        key = (which, ch_axis, ndim)
        hit = self._input_stats.get(key)
        if hit is None:
            src = np.asarray(self._input_mean, np.float32) \
                if which == "mean" \
                else np.float32(1) / np.asarray(self._input_std, np.float32)
            hit = torch.tensor(src, device=self._device)
            if hit.dim():
                shape = [1] * ndim
                shape[ch_axis] = hit.shape[0]
                hit = hit.reshape(shape)
            self._input_stats[key] = hit
        return hit

    def _stage(self, batch):
        """``batch`` as it is when it was staged already (tensors on the
        device, no uint8 data left to normalize), else :meth:`put_batch`."""
        normalize = (self._input_mean is not None
                     or self._input_std is not None)
        if all(isinstance(v, torch.Tensor) and v.device == self._device
               and not (normalize and v.dtype == torch.uint8
                        and k in self._data_names)
               for k, v in batch.items()):
            return batch
        return self.put_batch(batch)

    def _node_value_map(self, params, batch, aux):
        vals = {}
        for node in self._arg_nodes:
            vals[id(node)] = params[node.name] if node.name in params \
                else batch[node.name]
        for node in self._aux_nodes:
            vals[id(node)] = aux[node.name]
        return vals

    def _per_param_hyper(self, name):
        """(lr_mult, effective wd) of one param, reference semantics."""
        opt = self.optimizer
        return opt.lr_mult.get(name, 1.0), opt.wd_mult.get(name, 1.0) * opt.wd

    def _next_update(self):
        """Advance the update count; returns ``(lr, t)`` for this update.
        ``num_update`` honors ``begin_num_update``, so the schedule and
        Adam's bias correction continue across a resume."""
        opt = self.optimizer
        self._step_count += 1
        opt.num_update = max(opt.num_update,
                             opt.begin_num_update + self._step_count)
        lr = (opt.lr_scheduler(opt.num_update)
              if opt.lr_scheduler is not None else opt.lr)
        return lr, opt.num_update

    # ------------------------------------------------------------------ steps
    def _compute_view(self, params):
        """Compute-dtype copies of the f32 masters, as the graph sees them;
        under NHWC the 4-d (convolution) weights in ``channels_last``
        memory format, the layout cuDNN reads for an NHWC convolution."""
        view = {}
        for k, v in params.items():
            if self._layout == "NHWC" and v.dim() == 4:
                view[k] = v.to(self._compute_dtype,
                               memory_format=torch.channels_last)
            else:
                view[k] = v.to(self._compute_dtype)
        return view

    def _run_graph(self, view, batch, is_train):
        """``eval_graph`` under the trainer's image layout and block
        fusion: ``(heads, aux_updates)``."""
        with image_layout(self._layout), block_fusion(self._fuse_blocks):
            return eval_graph(self._topo, self.symbol._entries,
                              self._node_value_map(view, batch, self.aux),
                              is_train=is_train, device=self._device,
                              generator=self._generator if is_train
                              else None)

    def _train_step(self, batch, lr, t):
        leaves = {k: w.detach().requires_grad_(True)
                  for k, w in self.params.items()}
        heads, aux_upd = self._run_graph(self._compute_view(leaves), batch,
                                         True)
        loss_heads = [h for h, il in zip(heads, self._head_is_loss)
                      if il and h.requires_grad]
        if loss_heads:
            torch.autograd.backward(
                loss_heads, [torch.ones_like(h) for h in loss_heads])
        self._refresh_rule()
        rescale = self.optimizer.rescale_grad
        with torch.no_grad():
            for k, w in self.params.items():
                g = leaves[k].grad
                g = torch.zeros_like(w) if g is None else g.float() * rescale
                lr_mult, wd_eff = self._per_param_hyper(k)
                self._update_rule(w, g, self.opt_state[k], lr * lr_mult,
                                  wd_eff, t)
            # after the backward, which may still read the old statistics
            for node in self._aux_nodes:
                upd = aux_upd.get(id(node))
                if upd is not None:
                    self.aux[node.name].copy_(upd)
            return self._monitor_loss(heads, batch)

    def _monitor_loss(self, heads, batch):
        """mean -log p(label) of the first head when it is a loss head over
        (rows, classes) and a label input is fed; 0 otherwise."""
        loss = torch.zeros((), dtype=torch.float32, device=self._device)
        label = None
        for nm in self._input_names:
            if "label" in nm:
                label = batch[nm]
        if label is None or not self._head_is_loss[0]:
            return loss
        probs = heads[0]
        if probs.dim() == 2 and label.dim() >= 2 \
                and label.numel() == probs.shape[0]:
            label = label.reshape(-1)
        if probs.dim() == 2 and label.dim() == 1:
            # the label clipped into range, as the JAX step's mode="clip"
            idx = label.long().clamp(0, probs.shape[1] - 1).unsqueeze(1)
            p = probs.gather(1, idx)[:, 0].float()
            loss = -torch.log(p.clamp(min=1e-10)).mean()
        return loss

    def step(self, batch):
        """One training step.  ``batch``: dict name -> host array with the
        global batch dim, or a dict from :meth:`put_batch`.  Returns the
        monitoring loss as a 0-dim tensor on the device (reading it is a
        host sync)."""
        dev_batch = self._stage(batch)
        lr, t = self._next_update()
        return self._train_step(dev_batch, lr, t)

    def run_steps(self, batch, num_steps):
        """``num_steps`` training steps on one batch, staged once: the
        counterpart of the JAX trainer's scan chain, which is a loop here.
        The lr schedule advances per step as in :meth:`step`.  Returns the
        ``(num_steps,)`` loss tensor on the device; nothing in the loop
        waits for the device, so reading it is the one host sync."""
        dev_batch = self._stage(batch)
        losses = []
        for _ in range(num_steps):
            lr, t = self._next_update()
            losses.append(self._train_step(dev_batch, lr, t))
        return torch.stack(losses)

    def forward(self, batch, is_train=False):
        """Inference forward of the data inputs; returns the head tensors.
        Loss heads take zeros for missing labels.  As in the JAX trainer,
        the graph runs in inference mode whatever ``is_train`` says."""
        batch = {k: v for k, v in batch.items() if k in self._data_names}
        dev_batch = dict(self._stage(batch))
        bsz = next(iter(dev_batch.values())).shape[0]
        for n, s in self._label_shapes.items():
            dev_batch[n] = torch.zeros((bsz,) + tuple(s[1:]),
                                       dtype=torch.float32,
                                       device=self._device)
        with torch.inference_mode():
            heads, _aux = self._run_graph(self._compute_view(self.params),
                                          dev_batch, False)
            return heads

    def fusion_summary(self):
        """Summary of the most recent block-fusion plan in this process
        (blocks by kind, blocks on K5 as ``pallas_blocks``, fallback
        reasons): None before the first fused step or forward, or when
        ``fuse_blocks`` is off."""
        return _fusion.last_plan_summary() if self._fuse_blocks else None

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        raise MXNetError("ShardedTrainer checkpoints are not yet ported to "
                         "mxnet_tpu_torch")

    def load_checkpoint(self, prefix, epoch, load_optimizer_states=False):
        raise MXNetError("ShardedTrainer checkpoints are not yet ported to "
                         "mxnet_tpu_torch")
