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

Checkpoints are the JAX trainer's files: ``save_checkpoint`` writes
``prefix-symbol.json``, ``prefix-%04d.params`` (``arg:``/``aux:``, f32
OIHW, as the masters are held), with optimizer states
``prefix-%04d.states`` (``slot%d:<name>`` in the JAX slot order and
``meta:num_update``), and last the CRC32 manifest with the mesh descriptor
and the tracked data iterator's state; ``load_checkpoint`` verifies it,
checks every name, shape and slot before it changes any state, and stashes
the data state for ``restore_data_iter``.  A checkpoint of either package
loads in the other.  ``install_preemption_handler`` saves on SIGTERM and
exits 0: at once between steps, at the end of a step, save or load that
is running, never inside the update loop; with ``MXNET_TPU_FLIGHT_DIR`` set
it first dumps the flight recorder, as the JAX handler does.

Telemetry, as the JAX trainer's: each ``step`` is a ``trainer.step`` span
and trace, a ``step_begin`` flight event, a ``crash_guard`` and an
``annotate_oom``, and one ``telemetry.step_end`` record whose segments
split the host wall into ``input_wait`` (staging a host batch inside the
step, also charged to the ioview ``device_stage``) and ``compute`` (the
dispatch; the card runs behind it); ``run_steps`` is one
``trainer.run_steps`` record of ``count`` steps.  None of it waits for
the card.  ``MXNET_TPU_NUMERICS_EVERY`` samples parameter and gradient
statistics on every Nth step (one host fetch on a sampled step only).
The JAX trainer's TPU-era rewrites and kinds of parallelism are not
ported: setting one raises, as does loading a checkpoint saved at another
world size.

``strict=True`` (default: ``MXNET_TPU_STRICT_BIND``) verifies the graph at
the data and label shapes (:mod:`..analysis`, MXG001-009) before any op
runs or any state is allocated, then runs the static memory-liveness pass
over the training step (``analysis.memlive``: the optimizer's slots,
donated state) and records its prediction as ``trainer.step``; with a
budget armed an over-budget step raises (MXG017).  The first step after it
registers the allocator's peak as the measured total the prediction is
held against (``mxtpu_memlive_drift_ratio``).  The JAX pass's
distributed leg (``spmd.verify_trainer_config``) waits for multi-GPU
training.  ``step`` and ``run_steps`` are the ``trainer.step`` and
``trainer.run_steps`` cost-database seams (:meth:`cost_summary`); the port
rebuilds nothing (the update rule is made from the optimizer at each step,
and nothing compiles), so one dispatch scope serves a trainer's life.
"""
from __future__ import annotations

import contextlib
import logging
import math
import signal as _signal
import struct
import sys
import time

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..context import cpu
from .. import io_resume
from .. import ndarray as nd
from .. import resilience
from .. import telemetry
from ..telemetry import costdb as _costdb
from ..telemetry import flight as _flight, memory as _tmem
from ..telemetry import numerics as _numerics, tracing as _tracing
from ..telemetry import distview as _distview, ioview as _ioview
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
# ops of the port adapted to NHWC activations (ops/nn.py): their channel
# axis is remapped while the graph runs, so an explicit axis attr is fine;
# the JAX trainer's set
_NHWC_ADAPTED = frozenset({
    "Convolution", "Deconvolution", "Pooling", "BatchNorm", "Concat",
    "SliceChannel", "LRN", "InstanceNorm", "LeakyReLU", "UpSampling",
    "Crop", "Pad", "SoftmaxActivation", "Flatten", "FullyConnected",
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
        strict: verify the graph and the step's memory before anything
            runs (see the module docstring); None reads
            ``MXNET_TPU_STRICT_BIND``.
        fuse_conv_bn, stem_space_to_depth, strided_bwd_phase,
        conv1x1_as_dot, pipeline_stages > 1,
        sequence_parallel, tp_rules, native_weight_layout: not
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
        # the plan search's decisions: an ambient plan_decisions context
        # wins; otherwise the committed graph_plan entry (structural digest,
        # layout, this mesh's axis sizes, backend) is consulted once here,
        # and a hit plans every step, eval and captured forward by it
        self._plan_decisions = _fusion.active_decisions()
        if self._plan_decisions is None and self._fuse_blocks:
            from ..analysis import plansearch as _plansearch
            self._plan_decisions = _plansearch.committed_decisions(
                self._topo, symbol._entries, self._layout,
                mesh={str(k): int(v) for k, v in mesh.shape.items()},
                backend=_costdb.backend_name(self._device))
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
        if strict is None:
            from .. import config as _config
            strict = _config.get_bool("MXNET_TPU_STRICT_BIND")
        host_shapes = {**{n: tuple(s) for n, s in data_shapes.items()},
                       **{n: tuple(s) for n, s in self._label_shapes.items()}}
        if strict:
            # the graph verifier before any op runs (the JAX trainer's
            # verify_trainer_config, less its distributed leg)
            from ..analysis import verify_symbol
            verify_symbol(symbol, shapes=host_shapes).raise_if_errors(
                "ShardedTrainer strict bind")
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
        self._memlive_program = None
        if strict:
            # static memory liveness of the step (donated params, slots
            # and aux), recorded so the first step's measured peak is held
            # against it; with a budget armed an over-budget step is
            # refused here, before any state is allocated (MXG017)
            from ..analysis import memlive as _memlive
            from ..analysis.verifier import Report as _Report
            mem_report = _Report()
            _memlive.check_memory(
                symbol, shapes=host_shapes, report=mem_report,
                is_train=True, mesh={}, tp_rules={},
                n_slots=self._n_slots, donate=True, advice=False,
                record=True, program="trainer.step")
            mem_report.raise_if_errors("ShardedTrainer strict bind (memory)")
            self._memlive_program = "trainer.step"
        self._costdb_scope = _costdb.next_scope()
        self._step_cost = None

        # ---- f32 masters, initialized on the host, moved to the device
        _tmem.apply_budget(self._device)       # MXNET_TPU_MEMORY_BUDGET
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
        self._resume_epoch = 0       # the epoch last loaded
        self._preemption = None      # (handler, signum) awaiting the save
        self._busy = 0               # steps, saves and loads in progress
        # the data (position, state) that goes with the masters: taken at
        # each step's end, or the loaded checkpoint's
        self._step_data = (None, None)
        self._seg = {"input_s": 0.0, "collective_s": 0.0}
        self._numerics_chain_warned = False

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

    def _stage_timed(self, batch):
        """:meth:`_stage` inside a step: the wall of staging a host batch
        is the step's ``input_wait`` segment and the ioview
        ``device_stage`` stage (a batch staged already costs nothing)."""
        t0 = time.perf_counter()
        dev = self._stage(batch)
        if dev is batch:
            return dev
        dt = time.perf_counter() - t0
        self._seg["input_s"] += dt
        _ioview.account("device_stage", dt, items=1,
                        nbytes=sum(getattr(v, "nbytes", 0)
                                   for v in batch.values()))
        return dev

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
        with image_layout(self._layout), block_fusion(self._fuse_blocks), \
                _fusion.plan_decisions(self._plan_decisions):
            return eval_graph(self._topo, self.symbol._entries,
                              self._node_value_map(view, batch, self.aux),
                              is_train=is_train, device=self._device,
                              generator=self._generator if is_train
                              else None)

    def _train_step(self, batch, lr, t, stats_step=None):
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
            stats = None
            if stats_step is not None:
                # before the in-place update: the step's own parameters
                stats = _numerics.step_stats(
                    {k: v.detach() for k, v in leaves.items()},
                    {k: v.grad for k, v in leaves.items()
                     if v.grad is not None})
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
            loss = self._monitor_loss(heads, batch)
        if stats is not None:
            stats["loss"] = loss
            payload = _numerics.process_step(
                stats, step=stats_step, program="trainer.step",
                scope=("trainer.step", id(self)))
            if payload is not None:
                self._seg["numerics"] = payload
        return loss

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
        host sync).  The ``trainer.step`` seam fires first; a preemption
        signal that arrives during the step is served at its end, after
        the step's telemetry record.  Telemetry: see the module
        docstring."""
        with self._atomic():
            number = self._step_count + 1
            tr = _tracing.start_trace("trainer.step",
                                      attrs={"step": number})
            with tr:
                _flight.record("step_begin", program="trainer.step",
                               step=number)
                self._seg = {"input_s": 0.0, "collective_s": 0.0}
                t0 = time.perf_counter()
                ts0 = time.time()
                step_ctx = None
                with telemetry.span("trainer.step", category="trainer"), \
                        _flight.crash_guard("trainer.step"), \
                        _tmem.annotate_oom("trainer.step"):
                    step_ctx = _tracing.current()
                    resilience.fault_point("trainer.step")
                    dev_batch = self._stage_timed(batch)
                    lr, t = self._next_update()
                    number = self._resume_epoch + self._step_count
                    sampled = _numerics.sampled(number)
                    if sampled:
                        dev_batch = self._maybe_poison_batch(dev_batch)
                    loss = self._dispatch(
                        "trainer.step", dev_batch,
                        lambda: self._train_step(
                            dev_batch, lr, t,
                            stats_step=number if sampled else None))
                    self._stepped()
                total = time.perf_counter() - t0
                if step_ctx is not None:
                    self._record_segment_spans(step_ctx, ts0, total)
            telemetry.step_end(samples=self._batch_samples(batch),
                               step_time=total,
                               extra=self._segments_extra(total))
        return loss

    def _maybe_poison_batch(self, dev_batch):
        """The ``numerics.nonfinite`` seam, fired on sampled steps only:
        when armed (``MXNET_TPU_FAULTS``) the first float data input is
        multiplied by NaN instead of raising, so detection is what the
        fault exercises (a graph without one gets a parameter poisoned)."""
        try:
            resilience.fault_point("numerics.nonfinite")
            return dev_batch
        except resilience.FaultInjected:
            out = dict(dev_batch)
            for name in self._data_names:
                v = out[name]
                if v.is_floating_point() and name not in self._int_inputs:
                    out[name] = v * float("nan")
                    return out
            with torch.no_grad():
                self.params[self._param_names[0]].mul_(float("nan"))
            return dev_batch

    def _record_segment_spans(self, ctx, ts0, total_s):
        """The step's segments as trace spans under its ``trainer.step``
        span, laid out in turn from ``ts0``: input_wait, compute,
        collective_wait."""
        inp = max(0.0, float(self._seg["input_s"]))
        coll = max(0.0, float(self._seg["collective_s"]))
        comp = max(0.0, float(total_s) - inp - coll)
        _tracing.record_span(ctx, "step.input_wait", ts0, inp)
        _tracing.record_span(ctx, "step.compute", ts0 + inp, comp)
        _tracing.record_span(ctx, "step.collective_wait", ts0 + inp + comp,
                             coll)

    def _segments_extra(self, total_s, count=1):
        """The step's JSONL fields: the segment split (recorded into
        ``mxtpu_step_segment_seconds``), the loss when numerics sampled
        the step, and the compact numerics pair."""
        extra = {"segments": _distview.record_step_segments(
            total_s, input_s=self._seg["input_s"],
            collective_s=self._seg["collective_s"], count=count)}
        num = self._seg.get("numerics")
        if num is not None:
            gn = num.get("grad_norm")
            if isinstance(gn, float) and math.isfinite(gn):
                extra["grad_norm"] = gn
            extra["digest"] = num.get("digest")
            if _numerics.ledger_path() is None:
                extra["numerics"] = _numerics.json_safe(
                    {k: v for k, v in num.items() if k != "anomalies"})
        return extra

    @staticmethod
    def _batch_samples(batch):
        try:
            first = next(iter(batch.values()))
            return int(first.shape[0])
        except (StopIteration, AttributeError, IndexError, TypeError):
            return 0

    def run_steps(self, batch, num_steps):
        """``num_steps`` training steps on one batch, staged once: the
        counterpart of the JAX trainer's scan chain, which is a loop here.
        The lr schedule advances per step as in :meth:`step`.  Returns the
        ``(num_steps,)`` loss tensor on the device; nothing in the loop
        waits for the device, so reading it is the one host sync.  One
        ``trainer.run_steps`` span and one ``step_end`` record of
        ``count=num_steps``, as the JAX chain's."""
        if _numerics.enabled() and not self._numerics_chain_warned:
            # as the JAX chain: one opaque program, not sampled
            self._numerics_chain_warned = True
            logging.warning("MXNET_TPU_NUMERICS_EVERY is set but run_steps "
                            "chains are not sampled; use step() where "
                            "numerics coverage matters")
        _flight.record("step_begin", program="trainer.run_steps",
                       step=self._step_count + 1, count=num_steps)
        self._seg = {"input_s": 0.0, "collective_s": 0.0}
        t0 = time.perf_counter()
        with telemetry.span("trainer.run_steps", category="trainer"), \
                _flight.crash_guard("trainer.run_steps"), \
                _tmem.annotate_oom("trainer.run_steps"):
            dev_batch = self._stage_timed(batch)
            losses = []

            def chain():
                for _ in range(num_steps):
                    with self._atomic():
                        lr, t = self._next_update()
                        losses.append(self._train_step(dev_batch, lr, t))
                        self._stepped()
            self._dispatch("trainer.run_steps", dev_batch, chain,
                           steps=num_steps)
        total = time.perf_counter() - t0
        telemetry.step_end(samples=self._batch_samples(batch),
                           step_time=total / max(1, num_steps),
                           count=num_steps,
                           extra=self._segments_extra(total,
                                                      count=num_steps))
        return torch.stack(losses)

    def _dispatch(self, program, batch, fn, steps=1):
        """``fn()`` as one dispatch of ``program``: the cost-database seam
        (a sampled dispatch records its wall from CUDA events, with the
        step's analytic flops and bytes and the blocks and kernels it
        ran), and after a strict bind the first step's measured peak
        (:class:`..telemetry.memory.measured_dispatch`)."""
        obs = _costdb.begin_dispatch(
            program, key=(self._costdb_scope, id(self)), device=self._device)
        measure = None
        if self._memlive_program is not None:
            measure = _tmem.measured_dispatch(
                self._memlive_program, self._device,
                self._state_bytes() + sum(
                    v.numel() * v.element_size() for v in batch.values()))
            self._memlive_program = None
        try:
            if measure is None:
                out = fn()
            else:
                with measure:
                    out = fn()
        except BaseException:
            _costdb.end_dispatch(obs, failed=True)
            raise
        _costdb.end_dispatch(obs, args=batch, mesh={"data": 1},
                             steps=steps, cost=self._program_cost)
        return out

    def _state_bytes(self):
        """Bytes of the f32 masters, the optimizer's slots and the aux
        state."""
        n = sum(w.numel() * w.element_size() for w in self.params.values())
        n += sum(s.numel() * s.element_size()
                 for slots in self.opt_state.values() for s in slots)
        return n + sum(a.numel() * a.element_size()
                       for a in self.aux.values())

    def _program_cost(self):
        """Analytic ``(flops, bytes)`` of one step: the graph's node
        estimates at the step's shapes and compute dtype, times three (the
        costdb program records; the JAX records carry XLA's
        ``cost_analysis``)."""
        if self._step_cost is None:
            from ..analysis.perf import graph_cost
            types = {n: self._compute_dtype for n in self._param_names}
            types.update({n: self._compute_dtype for n in self._data_names
                          if n not in self._int_inputs})
            with image_layout(self._layout):
                self._step_cost = graph_cost(self.symbol, self._input_shapes,
                                             types, passes=3)
        return self._step_cost

    def cost_summary(self, top=5):
        """The cost database's roll-up (:mod:`..telemetry.costdb`): record
        counts, each program's measured wall, flops and MFU, and the
        ``top`` worst-MFU blocks and kernels."""
        return _costdb.summary(top=top)

    def health(self):
        """This rank's SLO health verdict (the ``mxtpu-health/1`` dict of
        ``telemetry.slo``).  The training-run rules are evaluated on the
        ``step_end`` cadence that :meth:`step` and :meth:`run_steps`
        already drive, so this is a read, not an evaluation."""
        from ..telemetry import slo
        return slo.health()

    @contextlib.contextmanager
    def _atomic(self):
        """A step, save or load in progress: a preemption signal that lands
        in it is served when the outermost one ends without raising."""
        self._busy += 1
        try:
            yield
        finally:
            self._busy -= 1
        if not self._busy:
            self._serve_preemption()

    def _stepped(self):
        """At a step's end, take the tracked iterator's position and state
        as the data that a preemption save before the next step records:
        a batch fetched and not yet stepped then stays unconsumed."""
        self._step_data = (io_resume.current_position(),
                           io_resume.data_state_entry())

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

    # ------------------------------------------------------------ checkpoints
    def mesh_descriptor(self):
        """The mesh and the parameters' partition in the JAX trainer's
        ``meta["mesh"]`` format: axis sizes, the saving world size (1) and
        each parameter's spec (all replicated on one device)."""
        return {"format": 2,
                "axes": {str(k): int(v) for k, v in self.mesh.shape.items()},
                "world": 1,
                "specs": {n: [] for n in self._param_names}}

    def _host_state(self, save_optimizer_states):
        """``(params and aux, states or None)`` as host f32 tensors under
        their file names, read after the step's work on the device."""
        host = {"arg:%s" % k: v.detach().float().cpu()
                for k, v in self.params.items()}
        host.update({"aux:%s" % k: v.detach().float().cpu()
                     for k, v in self.aux.items()})
        if not save_optimizer_states:
            return host, None
        st = {"meta:num_update": torch.tensor(
            [self.optimizer.begin_num_update + self._step_count],
            dtype=torch.int64)}
        for k, slots in self.opt_state.items():
            for i, sl in enumerate(slots):
                st["slot%d:%s" % (i, k)] = sl.detach().float().cpu()
        return host, st

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write ``prefix-symbol.json``, ``prefix-%04d.params`` (``arg:``
        and ``aux:`` names, f32, the reference OIHW weights, so a Module
        loads them) and, with ``save_optimizer_states``,
        ``prefix-%04d.states`` (``slot%d:<name>`` and ``meta:num_update``,
        the begin count plus the steps taken), each written whole or not at
        all; then the manifest, with ``meta["mesh"]``
        (:meth:`mesh_descriptor`) and the tracked iterator's position and
        ``data_state``.  The ``.states`` layout is the fused trainer's own,
        not the Module's pickled ``Updater`` states."""
        with self._atomic():
            self._write_checkpoint(prefix, epoch, save_optimizer_states,
                                   io_resume.current_position(),
                                   io_resume.data_state_entry())

    def _write_checkpoint(self, prefix, epoch, save_optimizer_states,
                          position, data_state):
        host, st = self._host_state(save_optimizer_states)
        resilience.atomic_write("%s-symbol.json" % prefix, self.symbol.save)
        param_name = "%s-%04d.params" % (prefix, epoch)
        resilience.atomic_write(
            param_name,
            lambda tmp: nd.save(tmp, {k: nd.NDArray(v)
                                      for k, v in host.items()}),
            fault_site="checkpoint.save")
        files = [param_name]
        arrays = dict(host)
        if st is not None:
            states_name = "%s-%04d.states" % (prefix, epoch)
            resilience.atomic_write(
                states_name,
                lambda tmp: nd.save(tmp, {k: nd.NDArray(v)
                                          for k, v in st.items()}))
            files.append(states_name)
            arrays.update(st)
        meta = {"mesh": self.mesh_descriptor()}
        if position is not None:
            meta["data_position"] = position
        if data_state is not None:
            meta["data_state"] = data_state
        resilience.write_manifest(prefix, epoch, files, arrays=arrays,
                                  meta=meta)

    @staticmethod
    def _load_file(path, what, epoch):
        try:
            return nd.load(path, ctx=cpu())
        except FileNotFoundError as e:
            raise MXNetError("checkpoint %s file %r is missing for epoch %d"
                             % (what, path, epoch)) from e
        except (MXNetError, ValueError, EOFError, struct.error) as e:
            raise MXNetError("checkpoint %s file %r is corrupt: %s"
                             % (what, path, e)) from e

    def _checked(self, what, name, arr, like):
        """``arr`` as f32 on the host, of ``like``'s shape, else raise."""
        t = arr.data.float()
        if tuple(t.shape) != tuple(like.shape):
            raise MXNetError(
                "checkpoint %s %r has shape %s, the trainer's is %s"
                % (what, name, tuple(t.shape), tuple(like.shape)))
        return t

    def load_checkpoint(self, prefix, epoch, load_optimizer_states=False):
        """Restore the parameters, moving statistics and (with
        ``load_optimizer_states``) the optimizer slots and update count of a
        checkpoint written by :meth:`save_checkpoint` of either package
        (``.params`` of a Module checkpoint load too).  Fires the
        ``checkpoint.load`` seam and verifies the manifest first; every
        name, shape and slot count is checked before any state changes, so
        a failed load leaves the trainer as it was.  A manifest naming
        another world size raises: resharding on load waits for
        multi-device training.  Afterwards the update count starts from
        the file's ``meta:num_update`` (Adam's bias correction and the lr
        schedule continue), and the checkpoint's data state is stashed for
        :meth:`restore_data_iter`."""
        with self._atomic():
            self._read_checkpoint(prefix, epoch, load_optimizer_states)

    def _read_checkpoint(self, prefix, epoch, load_optimizer_states):
        resilience.fault_point("checkpoint.load")
        manifest = resilience.verify_manifest(prefix, epoch)
        saved = (manifest or {}).get("meta", {}).get("mesh")
        if isinstance(saved, dict) and saved.get("world") is not None \
                and int(saved["world"]) != 1:
            raise MXNetError(
                "checkpoint %r epoch %d was saved by a world of %s "
                "processes; resharding it onto one device is not yet "
                "ported to mxnet_tpu_torch" % (prefix, epoch,
                                                saved["world"]))
        loaded = self._load_file("%s-%04d.params" % (prefix, epoch),
                                 "params", epoch)
        file_args = {k.split(":", 1)[1]: v for k, v in loaded.items()
                     if k.startswith("arg:")}
        file_aux = {k.split(":", 1)[1]: v for k, v in loaded.items()
                    if k.startswith("aux:")}
        missing = (set(self.params) - set(file_args)) | \
            (set(self.aux) - set(file_aux))
        unexpected = (set(file_args) - set(self.params)) | \
            (set(file_aux) - set(self.aux))
        if missing or unexpected:
            raise MXNetError(
                "checkpoint/model mismatch: missing %s, unexpected %s"
                % (sorted(missing), sorted(unexpected)))
        new_params = {k: self._checked("param", k, v, self.params[k])
                      for k, v in file_args.items()}
        new_aux = {k: self._checked("aux", k, v, self.aux[k])
                   for k, v in file_aux.items()}
        new_slots, new_num_update = None, None
        if load_optimizer_states:
            st = self._load_file("%s-%04d.states" % (prefix, epoch),
                                 "states", epoch)
            new_slots = {}
            for k, v in st.items():
                if k == "meta:num_update":
                    new_num_update = int(v.data.reshape(-1)[0])
                    continue
                slot, name = k.split(":", 1)
                i = int(slot[len("slot"):])
                if name not in self.opt_state:
                    raise MXNetError("optimizer state for %r, which the "
                                     "trainer has not" % name)
                new_slots.setdefault(name, {})[i] = self._checked(
                    "slot", k, v, self.params[name])
            for name, slots in self.opt_state.items():
                got = new_slots.get(name, {})
                if sorted(got) != list(range(len(slots))):
                    raise MXNetError(
                        "optimizer state mismatch for %r: file has %d "
                        "slots, trainer (%s) expects %d; resume with the "
                        "optimizer the checkpoint was saved with"
                        % (name, len(got), type(self.optimizer).__name__,
                           self._n_slots))
        with torch.no_grad():
            for k, v in new_params.items():
                self.params[k].copy_(v)
            for k, v in new_aux.items():
                self.aux[k].copy_(v)
            for name, slots in (new_slots or {}).items():
                for i, v in slots.items():
                    self.opt_state[name][i].copy_(v)
        if new_num_update is not None:
            self.optimizer.begin_num_update = new_num_update
        # the restored state is the new baseline: the steps counted before
        # it no longer describe it; the compute views are made from the
        # masters each step, the rule from the optimizer's attributes
        self._resume_epoch = int(epoch)
        self._step_count = 0
        self._refresh_rule()
        self._step_data = (None, None)
        if manifest is not None:
            meta = manifest.get("meta") or {}
            entry = meta.get("data_state")
            entry = entry if isinstance(entry, dict) else None
            self._step_data = (meta.get("data_position"), entry)
            io_resume.note_loaded_state(
                entry, source="%s epoch %d" % (prefix, epoch))

    def load_latest_checkpoint(self, prefix, load_optimizer_states=False):
        """Load the newest checkpoint under ``prefix`` that loads, passing
        over (with a warning) epochs whose files fail their manifest.
        Returns its epoch, or None when there is none (the run starts
        fresh)."""
        from ..model import find_checkpoints
        for ep in reversed(find_checkpoints(
                prefix, require_states=load_optimizer_states)):
            try:
                self.load_checkpoint(
                    prefix, ep, load_optimizer_states=load_optimizer_states)
                return ep
            except MXNetError as e:
                logging.warning("falling back past checkpoint epoch %d "
                                "of %r: %s", ep, prefix, e)
        return None

    def restore_data_iter(self, it):
        """Restore ``it`` from the data state the last load stashed, and
        track it, so later checkpoints record its state.  Returns the
        manifest entry applied, or None when there was none.  A failing
        restore leaves the entry stashed for another try."""
        io_resume.track(it)
        return io_resume.apply_pending(it)

    def install_preemption_handler(self, prefix, save_optimizer_states=True,
                                   signals=None, exit_process=True):
        """On SIGTERM (or ``signals``), checkpoint at epoch = the epoch last
        loaded + the steps taken since, and exit 0 (``exit_process``).
        The step is a loop of eager updates, so a signal that lands in a
        step (or a save or load) is served at its end; one that lands
        between steps (after the last, in validation, while the loop waits
        on data) is served at once.  Either way the checkpoint holds the
        state after the last step and the data state taken at that step's
        end (or, with no step since a load, the loaded checkpoint's), so a
        batch fetched and not yet stepped is not lost.  The flight-recorder
        dump of the JAX handler
        waits for the port's telemetry.  Returns the handler: ``pending``
        is True from the signal to the save, ``triggered`` after it."""
        if signals is None:
            signals = (_signal.SIGTERM,)

        def handler(signum, frame):
            if handler.pending:
                return
            handler.pending = True
            self._preemption = (handler, int(signum))
            if not self._busy:
                self._serve_preemption()

        handler.pending = False
        handler.triggered = False
        handler.prefix = prefix
        handler.save_optimizer_states = save_optimizer_states
        handler.exit_process = exit_process
        for sig in signals:
            _signal.signal(sig, handler)
        return handler

    def _serve_preemption(self):
        """Save and exit for a signal that has arrived."""
        if self._preemption is None:
            return
        handler, signum = self._preemption
        self._preemption = None
        epoch = self._resume_epoch + self._step_count
        logging.warning("preemption signal %d: checkpointing to %r epoch %d"
                        "%s", signum, handler.prefix, epoch,
                        " and exiting" if handler.exit_process else "")
        # black box first: if the grace window ends mid-save, the dump
        # still tells what the run was doing when the signal landed
        _flight.record("preemption", signum=int(signum), epoch=epoch)
        _flight.dump("sigterm")
        self._write_checkpoint(handler.prefix, epoch,
                               handler.save_optimizer_states,
                               *self._step_data)
        handler.pending = False
        handler.triggered = True
        if handler.exit_process:
            sys.exit(0)
