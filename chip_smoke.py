#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``env``: the card, CUDA and PyTorch versions, ``nvidia-smi``'s name and
   power limit, and TF32 switched off for matmuls and cuDNN (f32 means f32);
2. ``build``: every hand-written kernel built from ``mxnet_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a``, one process per source, all at once, with
   ``-Xptxas -v``'s report of the flash kernels, K5 and both K9 routes (no
   spill in K5 or either K9, no C7508 in the two kernels that move
   registers by ``setmaxnreg``);
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   the flash forward and then the flash backward, at the serving shape
   (B=4, T=1024, H=16, D=64) in f32 and bf16, causal and not, at the
   training shape (B=16, bf16, causal), at T=4096, at D=32 and D=128
   (B=4, H=8, causal) and at a ragged T=1000 (B=2, H=4, causal and not)
   and T=257 (B=3, H=5, causal), each in f32 and bf16; f32 runs the
   split-TF32 (3xTF32) mma.sync kernels, bf16 the wgmma (sm90) ones; error,
   kernel time, plain time, the time of the nearest PyTorch call and the
   bound the card's peak rates set (for f32 both the 3xTF32 bound of its
   route and the CUDA-core one); each gradient is held by its largest error
   and by its relative norm, and two backward launches on the same inputs
   must give bit-identical gradients; each f32 case also runs the plain
   version with TF32 matmuls as a control, which must miss every f32
   tolerance; then the delta kernel (rowsum(dO * O)) against its plain
   version, bit-identical across two launches, and
   ``_contrib_FlashAttention`` on inputs the kernels do not take (D=96
   f32, f16), which it must answer through ``attention_plain``;
4. ``serve``: the GPT LM at full width (vocab 16384, seq 1024, d_model 1024,
   16 heads, 12 layers; random weights from a seed) written as a checkpoint,
   loaded by ``Predictor`` on ``gpu(0)`` and served through ``BatchLadder``,
   ``Batcher`` and ``Server``: six one-row requests from threads, one
   three-row request, ``GET /healthz``; every answer checked, the kernel's
   launch count checked against the forwards run, one request recomputed
   on the CPU;
5. ``train``: ``models.gpt.build_bench_trainer`` at full width (batch 16,
   bf16, Adam lr 1e-4) on ``gpu(0)``: ten steps on the staged batch, every
   loss finite, the last below the first, the flash kernels (forward,
   backward, delta) launched once per layer per step; then ms/step,
   tokens/s and MFU by the port's
   ``transformer_mfu`` accounting, peak memory, and a profile of one step;
6. ``train_check``: one f32 SGD step of the full-width GPT cut to 2 layers
   and batch 1, on ``gpu(0)`` and on the CPU from the same weights; the
   change in every parameter agrees within a stated relative tolerance,
   and the same step with TF32 matmuls, run as a control, must not;
7. ``module_train``: ``train_lm.train()``'s Module route at full width
   (the GPT with dropout 0.1, f32, TF32 off) on ``gpu(0)``:
   ``Module.fit`` for one epoch of 8 batches of 16 sequences of a
   permutation chain (next token = perm[token], on 256 of the 16384
   tokens) through ``NDArrayIter``,
   with Xavier, Adam at 3e-3, Perplexity and Speedometer; every batch's
   perplexity finite and the last below the first, the flash forward,
   backward and delta launched once per layer per ``forward_backward`` and
   the forward once per layer per ``score`` batch; then ``score``,
   ``save_checkpoint`` and ``Module.load`` on ``gpu(0)``, whose score must
   equal the first within 1e-6; ms per batch, peak memory, and f32
   ``ShardedTrainer`` steps at the same width and batch beside them;
8. ``module_check``: train_check through the Module (one
   ``forward_backward`` + ``update`` with SGD of the GPT cut to 2 layers
   and batch 1, on ``gpu(0)`` and on the CPU, with the TF32 control);
9. ``bucketing_train``: ``BucketingModule.fit`` of the lstm_bucketing LSTM
   LM at the example's full width (2 LSTMCell layers of 200, embedding
   200, vocabulary 10000, batch 32, buckets 10 to 60, SGD lr 0.01, Xavier,
   Perplexity) on ``gpu(0)`` through ``tools/lstm_bucketing.py``:
   ``LSTM_EPOCHS`` epochs over a seeded corpus on a chain of 100 of the
   10000 tokens, in the iterator's order, with validation; 6 binds, all in
   the first epoch; every bucket on the default bucket's parameter,
   gradient and auxiliary storage, optimizer and Updater; the train
   perplexity falling and, in the last epoch, the train and validation
   perplexities below ``TOL_LSTM_PERPLEXITY`` (under the unigram's 100:
   the chain's successor learned); ms per ``fit`` batch and per
   ``forward_backward`` + ``update`` for each bucket, peak memory; every
   kernel's count, set to
   0 before and read after, must stay 0 (no kernel lies on this path);
10. ``bucketing_check``: four SGD steps of the same LM at 2 layers of 64,
   one batch of each of four buckets, on ``gpu(0)`` and on the CPU from
   the same weights and batches, with a TF32 control;
11. ``rnn_ops``: the ``RNN`` op (``FusedRNNCell``) against the same weights
   unfused into step cells, outputs and gradients: the LSTM at full width
   and the longest bucket with both routes' times, then GRU,
   bidirectional LSTM and GRU and the vanilla modes at a small size;
12. ``module_api``: ``examples/module_api/python_loss.py`` (an MLP
   ``Module`` in a ``SequentialModule`` with a ``PythonLossModule`` of
   the numpy hinge gradient) trained for 20 batches with its loss
   falling, and a ``Monitor`` on one bucket's executor of a bucketing LM
   giving a statistic for every op output of one batch;
13. ``kernels`` of K5 (``matmul_stats``, the GEMM with the BatchNorm
   statistics epilogue) against its plain version at the 8 shapes one
   ResNet-50 training step gives it in bf16, at 2 of them in f32 and at
   the cuda tests' shapes (one of which the wrapper pads for TMA in both
   dtypes), each bit-identical across two launches; per step shape the
   card's time (a CUDA graph's replay), the wrapper's host time, cuBLAS's
   bare product and the time with the host's share; at the 2 f32 shapes
   (split TF32 on the tensor cores) the card's time, cuBLAS's f32 product
   (TF32 off) and the bound of the product as split TF32 beside the
   CUDA-core one;
14. ``resnet_train``: ResNet-50 v2 at ``tools/bench.py``'s configuration
   (batch 128, 224x224, bf16, NHWC, block fusion, SGD momentum) on
   ``gpu(0)``: ten steps after a warm-up, every loss finite, the last
   below the first, every moving statistic moved, the fusion plan 50
   blocks with 16 on K5 and K5 launched 16 times a step, none of them
   through the wrapper's padding; then ms/step,
   images/s, peak memory and a profile of one step (K5's share, and the
   count of cuDNN layout transposes);
15. ``resnet_train_check``: one f32 SGD step of ResNet-50 at batch 8,
   64x64, on ``gpu(0)`` and on the CPU; every parameter's and moving
   statistic's change agrees within a stated relative tolerance, and a
   TF32 control must not;
16. ``image_io``: the records of the ImageNet path made on the card from
    seeds (``io_train_bench.make_class_rec``: 2048 train, 512 validation
    and 128 Module-route 256-px JPEGs of 4 colour classes); the JPEG
    decoders the host offers, the port's native library built from
    ``mxnet_tpu_torch/csrc/host`` (its compiler line and time), the native
    pipeline's images/s at 1, 2, 4 and all cores' decode threads, the
    validation records at one thread against all cores as multisets, and
    the decode against PIL's on the same records;
17. ``imagenet_train``: ``tools.train_imagenet``'s fused route (ResNet-50
    v2, batch 128, 224x224, bf16, NHWC, block fusion, SGD momentum 0.9, lr
    0.1, wd 1e-4) for two epochs of the train records through the native
    pipeline, raw uint8 normalized on the card, and a
    ``DevicePrefetchIter`` of depth 2, with validation; every loss finite
    and the last below the first, every moving statistic moved, 50 blocks
    with 16 on K5 and K5 launched 16 times a step (every other kernel 0),
    the last validation accuracy above ``TOL_VAL_ACCURACY``; then
    ``io_train_bench.train_loop`` sequential and prefetched (images/s,
    per-stage walls) beside ``resnet_train``'s staged-batch images/s, and
    three steps through the queue equal to the same three staged inline,
    to the bit;
18. ``imagenet_module``: the ``--fused 0`` route (``Module.fit``, f32
    NCHW, batch 32) on the Module records under ``MXNET_FUSE_BLOCKS=1``:
    the plan's blocks, none on K5 and every count 0, ms per batch;
19. ``rtc_kernels``: ``mx.rtc`` (K6) compiles the three flows of the JAX
    package's ``tests/test_rtc.py`` written in CUDA C, abs written as a
    CUDA programmer writes it for this card (float4 in a grid-stride
    loop), and both abs bodies over an (8192, 8192) f32 array, and pushes
    each once; each output equals the callable (plain) form's exactly; the
    two full-size ones are timed against ``torch.abs`` and their byte
    bound;
20. ``matmul_stats_experiment``: the tool of that name at its 8 ResNet-50
    shapes at batch 128, then K7 (K5 with c = 0) and K8 (the prologue
    variant) against their plain versions at each shape, bit-identical
    across two launches, with the kernel (the card's, and with the host's
    share), plain, library, cuBLAS product and bound times;
21. ``block_experiment``: the tool of that name at batch 128 with its
    defaults (64, 64, 256, rows 8, bf16: the wgmma kernel) and again in
    f32 (the general kernel), then K9 against ``block_plain`` at both
    stage-1 channel sets, (64, 64, 256) and (256, 64, 256), batch 128, in
    bf16 and in f32, with the card's time, the wall and host time a call,
    plain, library and bound times (f32: with a TF32 control that must
    miss ``TOL_BLOCK_F32``); at batch 2 every divisor of 56 as rows, every
    band height, and channel sets across the wgmma kernel's range; the
    general kernel at batch 2 on sets outside that range in bf16 ((64, 80,
    256), (24, 64, 256), (64, 64, 272), which raised before it existed,
    and the Wide ResNet sets (64, 128, 256) and (256, 128, 256)) and on
    those and the range sets in f32; each bit-identical across two
    launches; then the general kernel past cmid 256 at batch 1, cmid 512
    and 1024 in both dtypes, each in the tile its shared memory allows;
    cmid 4096 must raise in both dtypes.

Then the kernel summary line (each kernel with its count over
``bucketing_train`` beside the others) and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, and the script exits non-zero without the last
line.  With no CUDA device it exits 1 at once.
"""
from __future__ import annotations

import gc
import json
import logging
import os
import random
import re
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import mxnet_tpu_torch as mx                                   # noqa: E402
from mxnet_tpu_torch import cuda_build                         # noqa: E402
from mxnet_tpu_torch.models.gpt import (                       # noqa: E402
    build_bench_trainer, gpt_symbol)
from mxnet_tpu_torch.ops.flash_attention import (              # noqa: E402
    attention_plain, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_delta, flash_attention_delta_plain, flash_attention_fwd,
    flash_attention_plain)
from mxnet_tpu_torch.ops.registry import OpContext, get_op     # noqa: E402
from mxnet_tpu_torch.ops.fused import (                        # noqa: E402
    matmul_stats, matmul_stats_plain, matmul_stats_prologue,
    matmul_stats_prologue_plain)
from mxnet_tpu_torch.parallel import (                         # noqa: E402
    ShardedTrainer, build_mesh)
from mxnet_tpu_torch.serving import (                          # noqa: E402
    BatchLadder, Batcher, Server)
from mxnet_tpu_torch.tools.transformer_mfu import (            # noqa: E402
    H100_BF16_PEAK_TFLOPS, measure_steps)
from mxnet_tpu_torch.tools.bench import (                      # noqa: E402
    build_trainer as build_resnet_trainer, time_chains)
from mxnet_tpu_torch.tools import (                            # noqa: E402
    block_experiment, nvidia_smi)
from mxnet_tpu_torch.tools import matmul_stats_experiment      # noqa: E402
from mxnet_tpu_torch.tools import module_fit                   # noqa: E402
from mxnet_tpu_torch.tools import lstm_bucketing               # noqa: E402
from mxnet_tpu_torch.ops.rnn import rnn_param_size             # noqa: E402

#: the repo's benchmark configuration of the GPT LM
#: (examples/transformer/train_lm.py, build_bench_trainer)
FULL = {"vocab": 16384, "seq": 1024, "d_model": 1024, "heads": 16,
        "layers": 12}

# published H100 SXM peaks (NVIDIA data sheet, dense).  PEAK_FLOPS[bf16]
# is the route of every bf16 kernel; the f32 kernels (flash, K5, the
# general K9) run each product as three TF32 products on the tensor cores
# (split TF32), so their bound is 3 x flops at the TF32 peak, and
# PEAK_FLOPS[f32], the CUDA cores', gives the bound kept beside it
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TF32_FLOPS = 495e12
PEAK_NAME = {torch.float32: "f32 CUDA-core 67 TFLOP/s",
             torch.bfloat16: "bf16 tensor-core 989 TFLOP/s",
             "split_tf32": "f32 as split TF32: 3 x flops at the TF32 "
                           "tensor-core 495 TFLOP/s"}
HBM_BYTES_PER_S = 3.35e12

TOL_F32 = 1e-4      # max |kernel - plain|, o and lse, f32 inputs
TOL_BF16 = 2e-2     # max |kernel - plain in f32|, o, bf16 inputs
# backward, per gradient x against the plain version r (for bf16 inputs the
# plain version in f32 from the same bf16 inputs).  Two bounds: the largest
# entries, max |x - r| <= TOL_BWD_MAX * max |r| (+ 1e-5 in f32); and all of
# them, ||x - r|| / ||r|| <= TOL_BWD_NORM.  Under causal masking max |r|
# comes from the first rows and most entries are far smaller, so only the
# norm holds those.  The bf16 rounding of r itself, ||bf16(r) - r|| / ||r||,
# is recorded beside it as the floor a right bf16 kernel reads.
TOL_BWD_MAX = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_BWD_NORM = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# train_check: ||d_gpu - d_cpu|| / ||d_cpu|| per parameter, where d is the
# change of the parameter in one f32 SGD step.  Both sides sum in f32 in
# other orders (cuBLAS and the CUDA kernels; the CPU's BLAS and einsum), so
# a pre-activation within that rounding of 0 can take another ReLU mask on
# each side; the gradient of every parameter before that ReLU then gains or
# loses a whole term.  On the H100 the f32 step reads 7.8e-4 at worst and
# the same step with TF32 matmuls, run as a control, 2.8e-2: the bound lies
# between, near their geometric mean, and the control must exceed it.
TOL_TRAIN_CHECK = 5e-3

#: K5's launches in one training step of the bench configuration
#: (ResNet-50 v2, batch 128, 224x224, bf16, NHWC, block fusion): (M, K, N,
#: launches), M = 128 x 56 x 56, 128 x 28 x 28, 128 x 14 x 14, 128 x 7 x 7
K5_BENCH_SHAPES = [
    (401408, 64, 64, 1), (401408, 256, 64, 2), (401408, 256, 128, 1),
    (100352, 512, 128, 3), (100352, 512, 256, 1), (25088, 1024, 256, 5),
    (25088, 1024, 512, 1), (6272, 2048, 512, 2)]
#: the two of them also checked in f32
K5_F32_SHAPES = [(401408, 64, 64), (25088, 1024, 256)]
#: the cuda tests' shapes, off the path: ragged M and N, and (K = 30,
#: N = 70) a bf16 shape TMA does not take, which the wrapper pads
K5_ODD_SHAPES = [(1000, 72, 200), (4096, 256, 64), (300, 30, 70)]
K5_PER_STEP = sum(n for *_s, n in K5_BENCH_SHAPES)
# K5 against matmul_stats_plain on the same inputs: y in bf16 within one
# bf16 ulp of the plain y plus TOL_K5_Y_F32 * max |plain| (both round an
# f32 accumulator once; the accumulators differ by the f32 rounding of
# sums whose terms reach max |plain|, which near 0 is more than an ulp);
# y in f32 by max |y - plain| <= TOL_K5_Y_F32 * max |plain| (f32 FMAs in
# another order, K <= 2048); s1 and s2 by relative norm (f32 sums of up to
# 401408 rows in another order)
TOL_K5_Y_F32 = 1e-5
TOL_K5_SUMS = 1e-4
# resnet_train_check: ||d_gpu - d_cpu|| / ||d_cpu|| per parameter and per
# moving statistic, d the change in one f32 SGD step of ResNet-50 at batch
# 8, 64x64.  The moving statistics come from the forward alone: on the
# H100 they read 2.7e-5 at worst, the TF32 control 1.4e-2.  The parameters
# read 1.6e-2 at worst: fc1 (after the last ReLU) agrees to 3e-5, and every
# parameter before relu1 differs by 6e-3 to 1.6e-2, as another ReLU mask on
# a pre-activation within rounding of 0 gives; in stage 4 a BN channel sums
# only 32 values, so one such flip moves its gradient by about 1/sqrt(32).
# The TF32 control reads 0.50 there.  Each bound lies between the two
# readings, and the control must exceed both.
TOL_RESNET_CHECK = 5e-2
TOL_RESNET_CHECK_AUX = 1e-3
# K9 against block_plain: max |kernel - plain| <= TOL_BLOCK * max |plain|,
# the JAX tool's own limit.  The kernel rounds the three products' inputs
# to bf16 (as the library route does) where the plain version stays in f32
TOL_BLOCK = 5e-2
# K9 in f32 (the general kernel, split TF32) against block_plain in f32
# (cuBLAS, TF32 off), by max |kernel - plain| over max |plain|.  On the
# H100 the kernel read 3.2e-7 to 1.1e-6 at the block phase's 14 f32 sets
# (batch 2 and 128); the plain version with TF32 matmuls, run as a
# control, 4.7e-4 to 7.0e-4.  The bound lies between, near their
# geometric mean, and the control must exceed it.
TOL_BLOCK_F32 = 2e-5


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


# --------------------------------------------------------------------- model
def gpt_params(net, seq_len, seed=0):
    """Random weights from ``numpy.random.RandomState(seed)``, in argument
    order: N(0, 0.02) for weights, zeros for biases, ones and zeros for
    LayerNorm gamma and beta."""
    rng = np.random.RandomState(seed)
    shapes, _, _ = net.infer_shape(data=(1, seq_len),
                                   softmax_label=(1, seq_len))
    params = {}
    for name, shape in zip(net.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            params[name] = np.zeros(shape, np.float32)
        else:
            params[name] = rng.normal(0, 0.02, shape).astype(np.float32)
    return params


# -------------------------------------------------------------------- phases
def env_phase():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit("env", device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), cuda=torch.version.cuda,
         torch=torch.__version__, nvidia_smi=smi,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return smi


def ptxas_summary(text):
    """``-Xptxas -v``'s report of the flash kernels, one entry a kernel
    instantiation (``flash_fwd_tf32<64>``, ``flash_delta_kernel<64,bf16>``
    and the like): registers, static shared memory, stack frame and spill
    bytes."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            mangled = m.group(1)
            k = re.search(r"flash_[a-z0-9_]+?(?=I)", mangled)
            d = re.search(r"Li(\d+)E", mangled)
            name = None
            if k and d:
                name = "%s<%s%s>" % (k.group(0), d.group(1),
                                     ",bf16" if "nv_bfloat16" in mangled
                                     else "")
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(m.group(1)),
                             smem=int(smem.group(1)) if smem else 0)
    return out


#: template type arguments as the mangled names spell them
_MANGLED_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16"}


def kernel_ptxas_summary(text, kernel):
    """``-Xptxas -v``'s report of one source, one entry a kernel
    instantiation whose name matches the regular expression ``kernel``
    (``matmul_stats_sm90_kernel<256,0>``, ``stats_reduce_kernel``,
    ``bottleneck_general_kernel<f32,4>``; integer template arguments as
    integers, ``true`` and ``false`` as 1 and 0, float and bf16 as ``f32``
    and ``bf16``): registers, static shared memory, stack frame and spill
    bytes."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            k = re.search(r"\d+(%s)(?:I((?:L[ib]\d+E|13__nv_bfloat16|f)+)E)?"
                          % kernel, m.group(1))
            name = None
            if k:
                args = [i or _MANGLED_TYPES[t or f] for i, t, f in re.findall(
                    r"L[ib](\d+)E|(13__nv_bfloat16)|(f)", k.group(2) or "")]
                name = k.group(1) + ("<%s>" % ",".join(args) if args
                                     else "")
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(m.group(1)),
                             smem=int(smem.group(1)) if smem else 0)
    return out


def k5_ptxas_summary(text):
    """:func:`kernel_ptxas_summary` of ``csrc/matmul_stats.cu``
    (``matmul_stats_sm90_kernel<256,0>``, ``matmul_stats_f32_kernel<1,1>``,
    ``stats_reduce_kernel``)."""
    return kernel_ptxas_summary(text, r"(?:matmul_stats|stats)_\w+?kernel")


def block_ptxas_summary(text):
    """:func:`kernel_ptxas_summary` of ``csrc/bottleneck_block.cu``, one
    entry a middle width (``bottleneck_sm90_kernel<64>``)."""
    return kernel_ptxas_summary(text, r"bottleneck_\w+?kernel")


def general_block_ptxas_summary(text):
    """:func:`kernel_ptxas_summary` of ``csrc/bottleneck_block_general.cu``,
    one entry a dtype and tile height (``bottleneck_general_kernel<f32,4>``:
    16 x 4 positions a tile)."""
    return kernel_ptxas_summary(text, r"bottleneck_general_kernel")


def build_phase():
    """Every kernel built at once; ``-Xptxas -v``'s report of the flash
    kernels, of K5 (``matmul_stats``: the bf16 wgmma and the f32 split-TF32
    kernels) and of both K9 routes (``bottleneck_block`` and
    ``bottleneck_block_general``, with their ptxas warnings), and for the
    two kernels whose producer warpgroup hands its registers to the
    consumers (``setmaxnreg``: the bf16 forward and K5's bf16 kernel) and
    for K9 the highest register their SASS names.  ptxas's C7508 warning
    (``setmaxnreg`` ignored) in either of the two, or a spill in K5 or
    either K9, fails the phase."""
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    flash = {b["name"]: ptxas_summary(b["ptxas"]) for b in built
             if b["name"].startswith("flash_attention")}
    by_name = {b["name"]: b for b in built}
    flash["flash_attention_fwd_sm90"]["sass_registers"] = \
        cuda_build.sass_registers(
            cuda_build.library("flash_attention_fwd_sm90")._name)
    flash["matmul_stats"] = dict(
        k5_ptxas_summary(by_name["matmul_stats"]["ptxas"]),
        sass_registers=cuda_build.sass_registers(
            cuda_build.library("matmul_stats")._name))
    flash["bottleneck_block"] = dict(
        block_ptxas_summary(by_name["bottleneck_block"]["ptxas"]),
        sass_registers=cuda_build.sass_registers(
            cuda_build.library("bottleneck_block")._name),
        warnings=[ln for ln in by_name["bottleneck_block"]["ptxas"]
                  .splitlines() if "warning" in ln])
    flash["bottleneck_block_general"] = dict(
        general_block_ptxas_summary(
            by_name["bottleneck_block_general"]["ptxas"]),
        warnings=[ln for ln in by_name["bottleneck_block_general"]["ptxas"]
                  .splitlines() if "warning" in ln])
    emit("build", wall_s=time.perf_counter() - t0, kernels=built,
         flash_ptxas=flash)
    for name in ("flash_attention_fwd_sm90", "matmul_stats"):
        if "C7508" in by_name[name]["ptxas"]:
            raise SystemExit("build: ptxas ignored setmaxnreg in %s "
                             "(C7508): %s" % (name, by_name[name]["ptxas"]))
    for name in ("matmul_stats", "bottleneck_block",
                 "bottleneck_block_general"):
        spills = {k: v for k, v in flash[name].items()
                  if isinstance(v, dict) and "stack" in v
                  and (v["spill_stores"] or v["spill_loads"])}
        if spills:
            raise SystemExit("build: %s spills: %s"
                             % (name, json.dumps(spills)))
    return flash


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn()`` on the card: warmed, then ``iters``
    calls between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, t, h, d, dtype, causal, n_matmuls=2, n_tensors=4):
    """Least time for a flash kernel on this card: the larger of the flops
    over the route's peak and the bytes over HBM bandwidth.  The forward
    does 2 products and moves 4 (B, T, H, D) tensors (q, k, v read, o
    written); the backward does 5 and moves 8 (q, k, v, o, dO read; dq, dk,
    dv written); each also moves one f32 (B*H, T) lse.  Under causal only
    the t(t+1)/2 live (query, key) pairs are counted.  The f32 route runs
    each product as three TF32 products: its bound is 3 x flops at the TF32
    peak, and ``bound_cuda_core_ms`` beside it is the bound of f32 FMAs on
    the CUDA cores (67 TFLOP/s), which earlier f32 kernels ran and the
    kernel table keeps for comparison."""
    pairs = t * (t + 1) / 2 if causal else t * t
    flops = 2.0 * n_matmuls * b * h * d * pairs
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = float(n_tensors) * b * t * h * d * itemsize + 4.0 * b * h * t
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    f32 = dtype == torch.float32
    if f32:
        t_ops = 3.0 * flops / TF32_FLOPS * 1e3
        peak = PEAK_NAME["split_tf32"]
    else:
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        peak = PEAK_NAME[dtype]
    out = {"flops": flops, "bytes": nbytes,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "peak": peak + ", HBM 3.35 TB/s"}
    if f32:
        out["bound_cuda_core_ms"] = max(
            flops / PEAK_FLOPS[torch.float32] * 1e3, t_bytes)
    return out


#: the training path's attention: build_bench_trainer's batch 16, bf16
TRAIN_SHAPE = (16, 1024, 16, 64, torch.bfloat16, True)
#: the Module route's attention (module_train): the same shape in f32
MODULE_SHAPE = (16, 1024, 16, 64, torch.float32, True)
#: the flash cases of both kernels phases, each in both dtypes: the
#: serving shape, T=4096, the other head dims (whose shared-memory layout
#: and register budget differ: 64-byte bf16 rows at D=32, two 128-byte bf16
#: boxes at D=128; one, two and four 128-byte f32 boxes at D = 32, 64, 128)
#: and ragged T; and the training shape in both
FLASH_CASES = [(4, 1024, 16, 64, dt, causal)
               for dt in (torch.float32, torch.bfloat16)
               for causal in (True, False)] + [TRAIN_SHAPE, MODULE_SHAPE] + [
    case + (dt,) + causal
    for case, causal in (
        ((1, 4096, 16, 64), (True,)),
        ((4, 1024, 8, 32), (True,)),
        ((4, 1024, 8, 128), (True,)),
        ((2, 1000, 4, 64), (True,)),
        ((2, 1000, 4, 64), (False,)),
        # B*H*T not a multiple of 4: the backward's lse and delta rows
        # start off 16-byte boundaries in device memory
        ((3, 257, 5, 64), (True,)))
    for dt in (torch.float32, torch.bfloat16)]
#: the source each dtype's flash kernels are built from
FLASH_SOURCES = {
    "flash_attention_fwd": {
        "float32": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "bfloat16": "mxnet_tpu_torch/csrc/flash_attention_fwd_sm90.cu"},
    "flash_attention_bwd": {
        "float32": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "bfloat16": "mxnet_tpu_torch/csrc/flash_attention_bwd_sm90.cu"}}


def with_tf32(fn):
    """``fn()`` with TF32 matmuls (cuBLAS only: the flash kernels read no
    such switch), the setting restored after."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def control_misses(control, held):
    """The names of the tolerances a TF32 control passes: ``control`` maps
    each name to the control's reading, ``held`` to the bound the kernel is
    held to.  A bound the control passes cannot tell the split-TF32 kernel
    from one TF32 product."""
    return [name for name, x in control.items() if not x > held[name]]


def kernels_phase():
    """flash_attention_fwd against flash_attention_plain on the card; each
    f32 case also runs the plain version with TF32 matmuls as a control,
    which must miss both f32 tolerances."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    entries = []
    for b, t, h, d, dt, causal in FLASH_CASES:
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                   .to(dt) for _ in range(3))
        o, lse = flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ro, rl = flash_attention_plain(q.float(), k.float(), v.float(),
                                       causal)
        err_o = (o.float() - ro).abs().max().item()
        err_lse = (lse - rl).abs().max().item()
        tol_o = TOL_F32 if dt == torch.float32 else TOL_BF16
        ok = err_o <= tol_o and err_lse <= TOL_F32
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        dtype = str(dt).replace("torch.", "")
        entry = {
            "shape": [b, t, h, d], "dtype": dtype, "causal": causal,
            "source": FLASH_SOURCES["flash_attention_fwd"][dtype],
            "err_o": err_o, "err_lse": err_lse,
            "tol_o": tol_o, "tol_lse": TOL_F32, "ok": ok,
            "kernel_ms": cuda_ms(
                lambda: flash_attention_fwd(q, k, v, causal), 50),
            "plain_ms": cuda_ms(
                lambda: flash_attention_plain(q, k, v, causal), 5),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), 50),
        }
        entry.update(attention_bound(b, t, h, d, dt, causal))
        if dt == torch.float32:
            co, cl = with_tf32(lambda: flash_attention_plain(q, k, v, causal))
            control = {"err_o": (co - ro).abs().max().item(),
                       "err_lse": (cl - rl).abs().max().item()}
            entry["control_tf32"] = dict(control, passes=control_misses(
                control, {"err_o": tol_o, "err_lse": TOL_F32}))
            del co, cl
        entries.append(entry)
        del q, k, v, o, lse, ro, rl, qt, kt, vt
    emit("kernels", name="flash_attention_fwd", entries=entries)
    bad = [e for e in entries if not e["ok"]]
    if bad:
        raise SystemExit("flash_attention_fwd disagrees with its plain "
                         "version: %s" % json.dumps(bad))
    weak = [e for e in entries if e.get("control_tf32", {}).get("passes")]
    if weak:
        raise SystemExit("flash_attention_fwd: the TF32 control passes an "
                         "f32 tolerance, which then cannot tell the split "
                         "from one TF32 product: %s" % json.dumps(weak))
    return entries


def kernels_bwd_phase():
    """flash_attention_bwd against flash_attention_bwd_plain on the card,
    from the forward kernel's o and lse.  The library yardstick is the
    backward of ``F.scaled_dot_product_attention``, timed alone.  Each f32
    case also runs the plain version with TF32 matmuls as a control, which
    must miss both f32 tolerances of every gradient."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    entries = []
    for b, t, h, d, dt, causal in FLASH_CASES:
        q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                       .to(dt) for _ in range(4))
        o, lse = flash_attention_fwd(q, k, v, causal)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal)
        # no atomics: a second launch on the same inputs gives the same bits
        again = flash_attention_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
        del again
        ref = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), causal)
        f32 = dt == torch.float32
        grads = {}
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            ref_max = r.abs().max().item()
            ref_norm = r.norm().item()
            grads[name] = {
                "err": (x.float() - r).abs().max().item(),
                "ref_max": ref_max, "ref_mean": r.abs().mean().item(),
                "tol": TOL_BWD_MAX[dt] * ref_max + (1e-5 if f32 else 0.0),
                "rel_norm": (x.float() - r).norm().item() / ref_norm,
                "tol_norm": TOL_BWD_NORM[dt],
                "rounding_norm": (r.to(dt).float() - r).norm().item()
                / ref_norm}
        control = None
        if f32:
            ctrl = with_tf32(lambda: flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal))
            control = {}
            for name, c, r in zip(("dq", "dk", "dv"), ctrl, ref):
                control[name + "_err"] = (c - r).abs().max().item()
                control[name + "_rel_norm"] = \
                    (c - r).norm().item() / r.norm().item()
            held = {}
            for name, g in grads.items():
                held[name + "_err"] = g["tol"]
                held[name + "_rel_norm"] = g["tol_norm"]
            control["passes"] = control_misses(dict(control), held)
            del ctrl
        del got, ref
        ok = deterministic and all(
            g["err"] <= g["tol"] and g["rel_norm"] <= g["tol_norm"]
            for g in grads.values())
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        gt = do.transpose(1, 2)
        dtype = str(dt).replace("torch.", "")
        entry = {
            "shape": [b, t, h, d], "dtype": dtype, "causal": causal,
            "source": FLASH_SOURCES["flash_attention_bwd"][dtype],
            "deterministic": deterministic, "grads": grads,
            "max_abs_err": max(g["err"] for g in grads.values()), "ok": ok,
            "kernel_ms": cuda_ms(
                lambda: flash_attention_bwd(q, k, v, o, lse, do, causal),
                20),
            "plain_ms": cuda_ms(
                lambda: flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                  causal), 3),
            "library_ms": cuda_ms(
                lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                            retain_graph=True), 20),
        }
        entry.update(attention_bound(b, t, h, d, dt, causal, n_matmuls=5,
                                     n_tensors=8))
        if control is not None:
            entry["control_tf32"] = control
        entries.append(entry)
        del q, k, v, do, o, lse, qt, kt, vt, out, gt
    emit("kernels", name="flash_attention_bwd", entries=entries)
    bad = [e for e in entries if not e["ok"]]
    if bad:
        raise SystemExit("flash_attention_bwd disagrees with its plain "
                         "version: %s" % json.dumps(bad))
    weak = [e for e in entries if e.get("control_tf32", {}).get("passes")]
    if weak:
        raise SystemExit("flash_attention_bwd: the TF32 control passes an "
                         "f32 tolerance, which then cannot tell the split "
                         "from one TF32 product: %s" % json.dumps(weak))
    return entries


#: delta against its plain version: max |kernel - plain| <= TOL_DELTA *
#: max |plain|.  Both sum D products in f32 (a bf16 product is exact in
#: f32) in other orders, so they differ by the f32 rounding of those sums,
#: some 1e-7 of the largest row sum
TOL_DELTA = 1e-6


def delta_bound(b, t, h, d, dtype):
    """Least time for the delta kernel: dO and O read once, delta (f32)
    written once, over HBM bandwidth (one multiply-add a value read)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 2.0 * b * t * h * d * itemsize + 4.0 * b * h * t
    t_ops = 2.0 * b * t * h * d / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "peak": "HBM 3.35 TB/s"}


def delta_phase(bwd_entries):
    """flash_attention_delta against flash_attention_delta_plain on the
    card at every flash case's shape and dtype, bit-identical across two
    launches, with the kernel, plain, library and bound times; and the
    bf16 backward wrapper's time at the training shape (delta included),
    read from the backward phase.  The library yardstick is
    ``torch.linalg.vecdot`` for f32 (one call, the same sums as a (B, T,
    H) f32 tensor); for bf16 no one call sums the products in f32."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    entries = []
    for b, t, h, d, dt, causal in FLASH_CASES:
        if not causal and (b, t, h, d, dt, True) in FLASH_CASES:
            continue   # the same shapes as the causal case
        o, do = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                 .to(dt) for _ in range(2))
        got = flash_attention_delta(o, do)
        again = flash_attention_delta(o, do)
        torch.cuda.synchronize()
        ref = flash_attention_delta_plain(o, do)
        ref_max = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        entry = {"shape": [b, t, h, d], "dtype": str(dt)[6:],
                 "max_abs_err": err, "ref_max": ref_max,
                 "rel_err": err / ref_max, "tol": TOL_DELTA,
                 "deterministic": torch.equal(got, again),
                 "ok": err <= TOL_DELTA * ref_max and torch.equal(got, again),
                 "kernel_ms": cuda_ms(lambda: flash_attention_delta(o, do),
                                      50),
                 "plain_ms": cuda_ms(
                     lambda: flash_attention_delta_plain(o, do), 20),
                 "library_ms": cuda_ms(
                     lambda: torch.linalg.vecdot(do, o), 50)
                 if dt == torch.float32 else None}
        entry.update(delta_bound(b, t, h, d, dt))
        entries.append(entry)
        del o, do, got, again, ref
    bwd_train = _case(bwd_entries, list(TRAIN_SHAPE[:4]), "bfloat16")
    out = {"entries": entries, "tol": TOL_DELTA,
           "bwd_bf16_train_wrapper_ms": bwd_train["kernel_ms"]}
    emit("kernels", name="flash_attention_delta", **out)
    bad = [e for e in entries if not e["ok"]]
    if bad:
        raise SystemExit("flash_attention_delta disagrees with its plain "
                         "version or between launches: %s" % json.dumps(bad))
    return entries


def op_routes_phase():
    """``_contrib_FlashAttention`` on the card for inputs the kernels do
    not take (D=96 in f32; float16): the op answers them through
    ``attention_plain``, with no flash launch, as the JAX op sends them to
    ``_attention_jnp``."""
    op = get_op("_contrib_FlashAttention")
    attrs = op.parse_attrs({"causal": "True"})
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = []
    for shape, dt in (((2, 256, 4, 96), torch.float32),
                      ((2, 256, 4, 64), torch.float16)):
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda").to(dt)
                   for _ in range(3))
        before = flash_attention_fwd.launches
        got = op.fcompute(attrs, OpContext(device=q.device), q, k, v)
        torch.cuda.synchronize()
        launched = flash_attention_fwd.launches - before
        want = attention_plain(q, k, v, True)
        err = (got.float() - want.float()).abs().max().item()
        ok = launched == 0 and got.dtype == dt and got.shape == q.shape \
            and bool(torch.isfinite(got).all()) and err == 0.0
        cases.append({"shape": list(shape), "dtype": str(dt)[6:],
                      "flash_launches": launched, "max_abs_err": err,
                      "ok": ok})
        del q, k, v, got, want
    emit("op_routes", cases=cases)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit("_contrib_FlashAttention: inputs the kernels do not "
                         "take were not answered by attention_plain: %s"
                         % json.dumps(bad))
    return cases


def serve_phase(ctx, cfg, rungs=(1, 4), check_ctx=None):
    """Write a GPT checkpoint, serve it on ``ctx`` through Predictor ->
    BatchLadder -> Batcher -> Server, check every answer, and recompute one
    request on ``check_ctx`` (default: the CPU).  Returns the phase's
    fields; raises on any failed check."""
    check_ctx = check_ctx or mx.cpu()
    vocab, seq = cfg["vocab"], cfg["seq"]
    net = gpt_symbol(vocab, seq, cfg["d_model"], cfg["heads"],
                     cfg["layers"], dropout=0.0)
    params = gpt_params(net, seq)
    tokens = np.random.RandomState(1).randint(
        0, vocab, (9, seq)).astype(np.float32)
    on_card = ctx.device_type == "gpu"
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gpt")
        net.save(prefix + "-symbol.json")
        mx.nd.save(prefix + "-0000.params",
                   {"arg:" + k: mx.nd.array(v, ctx=mx.cpu())
                    for k, v in params.items()})
        del params
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        pred = mx.Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                            {"data": (1, seq)}, ctx=ctx)
        ladder = BatchLadder(pred, rungs=rungs)
        warm_ms = dict(ladder.describe()["wall_ms"])
        batcher = Batcher(ladder, window_ms=50, queue_depth=64,
                          default_deadline_ms=600000)
        server = Server(ladder, batcher=batcher, port=0,
                        host="127.0.0.1").start()
        results, errors = {}, []

        def go(i, rows):
            try:
                results[i] = batcher.submit({"data": tokens[i:i + rows]})[0]
            except Exception as e:  # collected and raised below
                errors.append(repr(e))

        try:
            threads = [threading.Thread(target=go, args=(i, 1))
                       for i in range(6)]
            threads.append(threading.Thread(target=go, args=(6, 3)))
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            alone = batcher.submit({"data": tokens[0:1]})[0]
            url = "http://127.0.0.1:%d/healthz" % server.port
            with urllib.request.urlopen(url, timeout=60) as r:
                health = json.loads(r.read())
        finally:
            server.close()
        serve_s = time.perf_counter() - t0
        launches = flash_attention_fwd.launches
        counts = batcher.dispatch_counts()
        peak = torch.cuda.max_memory_allocated() if on_card else None
        if errors or len(results) != 7:
            raise SystemExit("requests failed or were shed: %s" % errors)
        if health.get("status") != "ok":
            raise SystemExit("/healthz: %r" % health)
        for i, out in results.items():
            rows = 3 if i == 6 else 1
            if out.shape != (rows * seq, vocab) or \
                    not np.isfinite(out).all():
                raise SystemExit("request %d: shape %s or non-finite rows"
                                 % (i, out.shape))
            row_err = float(np.abs(out.sum(-1, dtype=np.float64) - 1).max())
            if row_err > 1e-4:
                raise SystemExit("request %d: rows sum to 1 within %g"
                                 % (i, row_err))
        alone_err = float(np.abs(np.log(alone) - np.log(results[0])).max())
        if alone_err > 1e-4:
            raise SystemExit("sequence 0 served alone differs from its "
                             "coalesced answer: max |d log p| = %g"
                             % alone_err)
        forwards = 2 * len(rungs) + sum(counts.values())
        want = cfg["layers"] * forwards if on_card else 0
        if launches != want:
            raise SystemExit("flash_attention_fwd launched %d times over %d "
                             "forwards; want %d" % (launches, forwards, want))
        ref = mx.Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                           {"data": (1, seq)}, ctx=check_ctx)
        ref.forward(data=tokens[0:1])
        dlogp = float(np.abs(np.log(ref.get_output(0))
                             - np.log(alone)).max())
        if dlogp > 1e-3:
            raise SystemExit("served vs %s recomputation: max |d log p| = %g"
                             % (check_ctx, dlogp))
        # after the launch count was read: these forwards are not counted
        profile = profile_dispatch(ladder, rungs[-1], seq) if on_card \
            else None
    return {"config": cfg, "context": str(ctx), "requests": 8,
            "request_rows": [1] * 6 + [3, 1],
            "dispatches_per_rung": {str(k): v for k, v in counts.items()},
            "forwards": forwards, "launches": launches,
            "launches_per_forward": launches / forwards,
            "warm_wall_ms": warm_ms,
            "ewma_wall_ms": ladder.describe()["wall_ms"],
            "serve_s": serve_s, "alone_vs_coalesced_dlogp": alone_err,
            "cross_check": str(check_ctx), "max_abs_dlogp": dlogp,
            "peak_mem_bytes": peak, "profile": profile}


def profile_device(fn, top=10, marks=None):
    """``fn()`` once under ``torch.profiler``, ending in a synchronize:
    its host wall, device time by kernel (copies included), the device's
    busy share of the wall and the top items.  ``marks``: name -> tuple
    of substrings of kernel names; for each, the matching kernels' device
    ms, launches and share of the device time (default: the flash
    kernels)."""
    marks = marks or {"flash_kernels": ("flash_",)}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((evt.key[:90], us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "busy_share": device_ms / wall_ms if wall_ms else None}
    for mark, keys in marks.items():
        hit = [r for r in rows if any(k in r[0] for k in keys)]
        ms = sum(r[1] for r in hit)
        out[mark + "_ms"] = ms
        out[mark + "_count"] = sum(r[2] for r in hit)
        out[mark + "_share_of_device"] = ms / device_ms if device_ms \
            else None
    out["top"] = [{"name": n, "ms": ms, "count": c}
                  for n, ms, c in rows[:top]]
    return out


def profile_dispatch(ladder, rung, seq, top=10):
    """One ladder dispatch at ``rung`` under ``torch.profiler``, after one
    unprofiled dispatch."""
    feed = {"data": np.zeros((rung, seq), np.float32)}
    ladder.dispatch(rung, feed)
    torch.cuda.synchronize()
    return dict(profile_device(lambda: ladder.dispatch(rung, feed), top),
                rung=rung)


def train_phase(ctx, cfg, batch=16, dtype="bfloat16", steps=10,
                timed_steps=5, repeats=2):
    """``build_bench_trainer`` at ``cfg`` on ``ctx``: ``steps`` steps on
    the staged batch with the launch counts set to 0 just before and read
    just after; every loss finite and the last below the first; then the
    best of ``repeats`` timed ``run_steps(timed_steps)`` by
    ``transformer_mfu.measure_steps`` and, on the card, peak memory and a
    profile of one step.  Raises on any failed check."""
    on_card = ctx.device_type == "gpu"
    t0 = time.perf_counter()
    trainer, staged = build_bench_trainer(
        vocab=cfg["vocab"], seq=cfg["seq"], d_model=cfg["d_model"],
        heads=cfg["heads"], layers=cfg["layers"], batch=batch, dtype=dtype,
        ctx=ctx)
    build_s = time.perf_counter() - t0

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    flash_attention_delta.launches = 0
    t0 = time.perf_counter()
    losses = [trainer.step(staged) for _ in range(steps)]
    losses = [float(x) for x in losses]
    sync()
    steps_s = time.perf_counter() - t0
    launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                "flash_attention_bwd": flash_attention_bwd.launches}
    delta_launches = flash_attention_delta.launches
    want = cfg["layers"] * steps if on_card else 0
    if any(n != want for n in list(launches.values()) + [delta_launches]):
        raise SystemExit("train: kernel launches %s and %d of the delta "
                         "kernel over %d steps of %d layers; want %d each"
                         % (launches, delta_launches, steps, cfg["layers"],
                            want))
    if not all(np.isfinite(losses)):
        raise SystemExit("train: non-finite loss in %s" % losses)
    if not losses[-1] < losses[0]:
        raise SystemExit("train: loss did not fall over %d steps: %s"
                         % (steps, losses))
    m = measure_steps(trainer, staged, timed_steps, repeats,
                      cfg["d_model"], cfg["layers"], cfg["seq"], cfg["vocab"])
    if not torch.isfinite(m["losses"]).all():
        raise SystemExit("train: non-finite loss in the timed steps")
    out = {"config": cfg, "batch": batch, "dtype": dtype,
           "context": str(ctx), "optimizer": "adam", "learning_rate": 1e-4,
           "params": sum(int(v.numel()) for v in trainer.params.values()),
           "build_s": build_s, "steps": steps, "losses": losses,
           "steps_wall_s": steps_s, "launches": launches,
           "delta_launches": delta_launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "timed_steps": timed_steps, "repeats_s": m["repeats_s"],
           "step_ms": m["step_ms"], "tokens_per_s": m["tokens_per_s"],
           "train_flop_per_token": m["accounting"]["train"],
           "step_tflop": m["step_tflop"],
           "tflops_per_s": m["tflops_per_s"], "mfu": m["mfu"],
           "mfu_peak": "bf16 dense %g TFLOP/s" % H100_BF16_PEAK_TFLOPS}
    if on_card:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        # after the launch count was read: this step is not counted
        out["profile"] = profile_device(lambda: trainer.step(staged), top=12)
    return out


def update_diff(delta, ref, each=False):
    """Per parameter, ||delta - ref|| / ||ref|| of two updates (dicts of CPU
    tensors): the worst, its name and the median (and all of them when
    ``each``)."""
    rel = {k: (delta[k] - d).norm().item() / max(d.norm().item(), 1e-30)
           for k, d in ref.items()}
    worst = max(rel, key=rel.get)
    out = {"max_rel_update_diff": rel[worst], "worst_param": worst,
           "median_rel_update_diff": float(np.median(list(rel.values())))}
    if each:
        out["rel_update_diff"] = rel
    return out


def flash_counts():
    """The launch counts of the flash forward, backward and delta kernels."""
    return {"flash_attention_fwd": flash_attention_fwd.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "flash_attention_delta": flash_attention_delta.launches}


def zero_flash_counts():
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    flash_attention_delta.launches = 0


def train_check_phase(ctx, cfg, layers=2, lr=1.0, check_ctx=None):
    """One f32 SGD step (no momentum) of the GPT at ``cfg``'s width with
    ``layers`` layers and batch 1, on ``ctx`` and on ``check_ctx`` (default:
    the CPU), from the same seeded weights.  Per parameter, the relative
    norm of the difference of the two updates must stay within
    ``TOL_TRAIN_CHECK``.  On the card the step is also run with TF32
    matmuls as a control, whose worst difference must exceed the bound:
    the check then tells an f32 step from a lower-precision one."""
    check_ctx = check_ctx or mx.cpu()
    seq = cfg["seq"]
    net = gpt_symbol(cfg["vocab"], seq, cfg["d_model"], cfg["heads"],
                     layers, dropout=0.0)
    x = np.random.RandomState(2).randint(0, cfg["vocab"], (1, seq)) \
        .astype(np.float32)
    batch = {"data": x, "softmax_label": np.roll(x, -1, 1).copy()}

    def one_step(c, tf32=False):
        trainer = ShardedTrainer(
            net, build_mesh(devices=[c]), data_shapes={"data": (1, seq)},
            label_shapes={"softmax_label": (1, seq)}, optimizer="sgd",
            learning_rate=lr, momentum=0.0, dtype="float32", seed=0)
        before = {k: v.to("cpu", copy=True)
                  for k, v in trainer.params.items()}
        torch.backends.cuda.matmul.allow_tf32 = tf32
        flash_attention_fwd.launches = 0
        flash_attention_bwd.launches = 0
        flash_attention_delta.launches = 0
        try:
            loss = float(trainer.step(batch))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        launches[str(c) + (" tf32" if tf32 else "")] = {
            "flash_attention_fwd": flash_attention_fwd.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "flash_attention_delta": flash_attention_delta.launches}
        return loss, {k: trainer.params[k].cpu() - before[k] for k in before}

    compare = update_diff
    launches = {}
    loss, delta = one_step(ctx)
    ref_loss, ref_delta = one_step(check_ctx)
    losses = [loss, ref_loss]
    out = {"config": dict(cfg, layers=layers), "batch": 1,
           "optimizer": "sgd", "learning_rate": 0.1, "dtype": "float32",
           "contexts": [str(ctx), str(check_ctx)], "losses": losses,
           "params": len(ref_delta), **compare(delta, ref_delta, True),
           "tol": TOL_TRAIN_CHECK, "control_tf32": None,
           "launches": launches}
    del delta
    if ctx.device_type == "gpu":
        tf32_loss, tf32_delta = one_step(ctx, tf32=True)
        losses.append(tf32_loss)
        out["control_tf32"] = compare(tf32_delta, ref_delta)
    if out["max_rel_update_diff"] > TOL_TRAIN_CHECK \
            or not np.isfinite(losses).all():
        raise SystemExit("train_check: %s" % json.dumps(out))
    # the f32 step on the card runs the split-TF32 flash kernels (and the
    # delta kernel) once a layer
    want = layers if ctx.device_type == "gpu" else 0
    if any(n != want for n in launches[str(ctx)].values()):
        raise SystemExit("train_check: flash launches %s in one step of %d "
                         "layers; want %d each"
                         % (launches[str(ctx)], layers, want))
    if out["control_tf32"] is not None and \
            out["control_tf32"]["max_rel_update_diff"] <= TOL_TRAIN_CHECK:
        raise SystemExit("train_check: the TF32 control passes the bound, "
                         "so the bound cannot tell it from f32: %s"
                         % json.dumps(out))
    return out


# ------------------------------------------------------------ Module API
class _LogLines(logging.Handler):
    """Keeps the messages logged while it is attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


#: the tokens module_train's chain walks, and its batches: at lr 3e-3 the
#: full-width GPT learns the unigram of the chain in three batches and
#: its bigram only on 64 tokens, below 64 from batch 10 and about 27 over
#: batches 17 to 20; on 256 and 16384 tokens it did not in 32 batches, nor
#: did the f32 ShardedTrainer on the same weights and draws (PERF.md)
CHAIN_SUPPORT = module_fit.SUPPORT
MODULE_BATCHES = module_fit.BATCHES


def _tail_perplexity(per_batch, n=4):
    """The geometric mean of the last ``n`` batches' perplexities."""
    return float(np.exp(np.mean(np.log(per_batch[-n:]))))


def module_train_phase(ctx, cfg, batch=16, batches=MODULE_BATCHES, lr=3e-3,
                       trainer_steps=3):
    """``train_lm.train()``'s Module route at ``cfg``'s width
    (``tools.module_fit.fit``): the GPT with dropout 0.1 in f32,
    ``Module(net, context=ctx).fit`` over an ``NDArrayIter`` of ``batches``
    batches of the permutation chain on ``CHAIN_SUPPORT`` tokens (Xavier,
    Adam at ``lr``, Perplexity, Speedometer(batch, 2)), the flash counts
    set to 0 just before and read just after; each batch's perplexity
    (finite, the last below the first) and time; then ``score``, the
    checkpoint written and loaded by ``Module.load`` on ``ctx``, and a
    second score equal to the first within 1e-6.  The bigram must be
    learned, not only the unigram (a perplexity of ``CHAIN_SUPPORT``): the
    last four batches' perplexity (their geometric mean) and the score
    stay below ``CHAIN_SUPPORT``.  Beside it, on the card,
    ``trainer_steps`` timed steps of ``ShardedTrainer`` in f32 at the same
    width and batch (dropout 0), and peak memory.  Raises on any failed
    check."""
    on_card = ctx.device_type == "gpu"
    layers = cfg["layers"]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    log = _LogLines()
    logging.getLogger().addHandler(log)
    old_level = logging.getLogger().level
    logging.getLogger().setLevel(logging.INFO)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    try:
        zero_flash_counts()
        run = module_fit.fit(ctx, cfg, batch, batches, lr, CHAIN_SUPPORT)
        fit_launches = flash_counts()
    finally:
        logging.getLogger().removeHandler(log)
        logging.getLogger().setLevel(old_level)
    mod, it, per_batch = run["module"], run["iter"], run["batch_perplexity"]
    first_ms, batch_ms, fit_s = (run["setup_and_first_batch_ms"],
                                 run["batch_ms"], run["fit_s"])
    peak_fit = torch.cuda.max_memory_allocated() if on_card else None

    zero_flash_counts()
    t0 = time.perf_counter()
    score = mod.score(it, mx.metric.Perplexity(None))[0][1]
    sync()
    score_s = time.perf_counter() - t0
    score_launches = flash_counts()

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gpt")
        t0 = time.perf_counter()
        mod.save_checkpoint(prefix, 1)
        save_s = time.perf_counter() - t0
        params_bytes = os.path.getsize(prefix + "-0001.params")
        t0 = time.perf_counter()
        loaded = mx.mod.Module.load(prefix, 1, context=ctx)
        loaded.bind(data_shapes=it.provide_data,
                    label_shapes=it.provide_label, for_training=False)
        load_s = time.perf_counter() - t0
    score2 = loaded.score(it, mx.metric.Perplexity(None))[0][1]
    n_params = sum(int(v.size) for v in mod.get_params()[0].values())
    del loaded, mod, run
    peak = torch.cuda.max_memory_allocated() if on_card else None

    out = {"config": dict(cfg, dropout=0.1), "context": str(ctx),
           "batch": batch, "batches": batches, "dtype": "float32",
           "chain_support": CHAIN_SUPPORT, "optimizer": "adam",
           "learning_rate": lr, "params": n_params,
           "batch_perplexity": per_batch,
           "tail_perplexity": _tail_perplexity(per_batch),
           "setup_and_first_batch_ms": first_ms, "batch_ms": batch_ms,
           "fit_s": fit_s, "fit_launches": fit_launches,
           "launches_per_forward_backward": {
               k: v / batches for k, v in fit_launches.items()},
           "score": score, "score_s": score_s,
           "score_launches": score_launches,
           "forward_launches_per_score_batch":
               score_launches["flash_attention_fwd"] / batches,
           "checkpoint": {"params_bytes": params_bytes, "save_s": save_s,
                          "load_bind_s": load_s, "score": score2,
                          "rel_diff": abs(score2 - score) / score},
           "speedometer": [ln for ln in log.lines if "Speed:" in ln],
           "peak_mem_bytes_fit": peak_fit, "peak_mem_bytes": peak}
    if on_card:
        out["nvidia_smi"] = nvidia_smi()
        out["ms_per_fit_batch_median"] = float(np.median(batch_ms))
        torch.cuda.empty_cache()
        trainer, staged = build_bench_trainer(
            vocab=cfg["vocab"], seq=cfg["seq"], d_model=cfg["d_model"],
            heads=cfg["heads"], layers=layers, batch=batch,
            dtype="float32", ctx=ctx)
        trainer.step(staged)
        sync()
        t0 = time.perf_counter()
        trainer.run_steps(staged, trainer_steps)
        sync()
        out["sharded_trainer_f32_step_ms"] = \
            (time.perf_counter() - t0) * 1e3 / trainer_steps
        del trainer, staged
        torch.cuda.empty_cache()

    want = layers if on_card else 0
    bad = []
    if not all(np.isfinite(per_batch)) or not np.isfinite(score):
        bad.append("non-finite perplexity")
    if not per_batch[-1] < per_batch[0]:
        bad.append("perplexity did not fall")
    if not (out["tail_perplexity"] < CHAIN_SUPPORT
            and score < CHAIN_SUPPORT):
        bad.append("the bigram was not learned: the last batches read %r "
                   "and the score %r, the unigram %d"
                   % (out["tail_perplexity"], score, CHAIN_SUPPORT))
    if any(v != want * batches for v in fit_launches.values()):
        bad.append("flash launches %s over %d forward_backward; want %d "
                   "each" % (fit_launches, batches, want * batches))
    if score_launches != {"flash_attention_fwd": want * batches,
                          "flash_attention_bwd": 0,
                          "flash_attention_delta": 0}:
        bad.append("score's flash launches %s over %d batches"
                   % (score_launches, batches))
    if not out["checkpoint"]["rel_diff"] <= 1e-6:
        bad.append("the loaded checkpoint scores %r, the module %r"
                   % (score2, score))
    if bad:
        raise SystemExit("module_train: %s: %s" % ("; ".join(bad),
                                                    json.dumps(out)))
    return out


def module_check_phase(ctx, cfg, layers=2, lr=1.0, check_ctx=None):
    """One ``forward_backward`` + ``update`` of ``Module`` with SGD (no
    momentum, ``lr``) of the GPT at ``cfg``'s width with ``layers`` layers,
    batch 1 and dropout 0, on ``ctx`` and on ``check_ctx`` (default: the
    CPU) from the same seeded weights; per parameter the updates agree
    within ``TOL_TRAIN_CHECK`` (:func:`update_diff`, as train_check), and
    on the card the same step with TF32 matmuls, run as a control, must
    miss it."""
    check_ctx = check_ctx or mx.cpu()
    seq = cfg["seq"]
    net = gpt_symbol(cfg["vocab"], seq, cfg["d_model"], cfg["heads"],
                     layers, dropout=0.0)
    x = np.random.RandomState(2).randint(0, cfg["vocab"], (1, seq)) \
        .astype(np.float32)
    y = np.roll(x, -1, 1).copy()
    weights = gpt_params(net, seq, seed=0)
    launches = {}

    def one_step(c, tf32=False):
        it = mx.io.NDArrayIter(x, y, 1)
        mod = mx.mod.Module(net, context=c)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in weights.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": lr, "momentum": 0.0})
        b = next(it)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        zero_flash_counts()
        try:
            mod.forward_backward(b)
            mod.update()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        launches[str(c) + (" tf32" if tf32 else "")] = flash_counts()
        m = mx.metric.Perplexity(None)
        m.update(b.label, mod.get_outputs())
        after = mod.get_params()[0]
        return float(np.log(m.get()[1])), {
            k: torch.from_numpy(after[k].asnumpy() - w)
            for k, w in weights.items()}

    loss, delta = one_step(ctx)
    ref_loss, ref_delta = one_step(check_ctx)
    losses = [loss, ref_loss]
    out = {"config": dict(cfg, layers=layers), "batch": 1,
           "optimizer": "sgd", "learning_rate": lr, "dtype": "float32",
           "contexts": [str(ctx), str(check_ctx)], "losses": losses,
           "params": len(ref_delta), **update_diff(delta, ref_delta, True),
           "tol": TOL_TRAIN_CHECK, "control_tf32": None,
           "launches": launches}
    del delta
    if ctx.device_type == "gpu":
        tf32_loss, tf32_delta = one_step(ctx, tf32=True)
        losses.append(tf32_loss)
        out["control_tf32"] = update_diff(tf32_delta, ref_delta)
    if out["max_rel_update_diff"] > TOL_TRAIN_CHECK \
            or not np.isfinite(losses).all():
        raise SystemExit("module_check: %s" % json.dumps(out))
    want = layers if ctx.device_type == "gpu" else 0
    if any(n != want for n in launches[str(ctx)].values()):
        raise SystemExit("module_check: flash launches %s in one step of %d "
                         "layers; want %d each"
                         % (launches[str(ctx)], layers, want))
    if out["control_tf32"] is not None and \
            out["control_tf32"]["max_rel_update_diff"] <= TOL_TRAIN_CHECK:
        raise SystemExit("module_check: the TF32 control passes the bound, "
                         "so the bound cannot tell it from f32: %s"
                         % json.dumps(out))
    return out


# -------------------------------------------------- BucketingModule, RNN
#: the lstm_bucketing configuration (examples/rnn/lstm_bucketing.py:24-40):
#: 2 LSTMCell layers, 200 hidden, embedding 200, batch 32, buckets 10 to
#: 60, SGD lr 0.01 momentum 0 wd 1e-5, PTB's vocabulary of 10000
LSTM_FULL = {"vocab": 10000, "num_hidden": 200, "num_embed": 200,
             "num_layers": 2, "batch_size": 32}
#: bucketing_train's corpus (lstm_bucketing.successor_corpus: a chain that
#: cycles SUPPORT tokens of the 10000) and its epochs
LSTM_SENTENCES = lstm_bucketing.SENTENCES
LSTM_VAL_SENTENCES = 400
LSTM_EPOCHS = 8
# bucketing_train fails unless the last epoch's train and validation
# perplexities are below this bound: the uniform model reads 10000 and a
# model of the chain's unigram alone the support, 100, so the bound needs
# the successor learned.  On the H100 the tool's run of the same seeds
# read, after the eighth epoch, 10.12 in training and 12.24 in validation
# (after the fifth 99.67 and 94.60: the unigram's plateau, left in the
# sixth); the bound is twice the larger
TOL_LSTM_PERPLEXITY = 25.0
# bucketing_check: ||d_gpu - d_cpu|| / ||d_cpu|| per parameter, d the
# change of the parameter over BUCKET_CHECK_STEPS SGD steps of the
# bucketing LM at 2 layers and a narrow width (no ReLU: no mask flips).
# On the H100 the f32 steps read 7.4e-7 at worst and the same steps with
# TF32 matmuls, run as a control, 8.1e-4: the bound lies between, near
# their geometric mean, and the control must exceed it
TOL_BUCKETING_CHECK = 2e-5
BUCKET_CHECK = {"vocab": 500, "num_hidden": 64, "num_embed": 64,
                "num_layers": 2, "batch_size": 8}
BUCKET_CHECK_STEPS = 4
# rnn_ops: the RNN op against its unfused cells on the same weights and
# inputs, max |fused - unfused| over max |unfused| for the outputs and
# every gradient (f32, TF32 off: the same products in another grouping)
TOL_RNN_OPS = 1e-5


def all_counts():
    """The launch counts of every hand-written kernel of the port."""
    from mxnet_tpu_torch.rtc import Rtc
    bk = block_experiment.block_kernel
    return dict(flash_counts(), matmul_stats=matmul_stats.launches,
                matmul_stats_prologue=matmul_stats_prologue.launches,
                rtc=Rtc.launches, bottleneck_block=bk.launches,
                bottleneck_block_general=bk.general_launches)


def zero_all_counts():
    from mxnet_tpu_torch.rtc import Rtc
    bk = block_experiment.block_kernel
    zero_flash_counts()
    matmul_stats.launches = matmul_stats_prologue.launches = 0
    Rtc.launches = 0
    bk.launches = bk.general_launches = 0


def _first_batches(batches):
    """Each bucket's first batch's ms in the first epoch (its bind
    included)."""
    out = {}
    for b in batches:
        out.setdefault(str(b["bucket"]), b["ms"])
    return dict(sorted(out.items()))


def bucketing_train_phase(ctx, cfg=LSTM_FULL, sentences=LSTM_SENTENCES,
                          val_sentences=LSTM_VAL_SENTENCES,
                          epochs=LSTM_EPOCHS, bound=TOL_LSTM_PERPLEXITY,
                          lr=0.01):
    """``BucketingModule.fit`` of the lstm_bucketing LM at ``cfg``'s width
    on ``ctx`` (``tools.lstm_bucketing.fit``, SGD at ``lr``, the
    example's 0.01): ``epochs`` epochs over the seeded successor corpus in the iterator's order, with validation, the
    kernel counts set to 0 just before and read just after (no kernel lies
    on this path).  Checks: 6 binds, all in the first epoch, none while
    each bucket is timed again after; every bucket holds the default
    bucket's parameter, gradient and auxiliary storage, host parameters,
    optimizer and Updater; the train perplexity finite and falling from
    epoch to epoch, the last epoch's train and validation perplexities
    below ``bound``.  Reports for each bucket the median ms of a ``fit``
    batch past the first epoch and of ``forward_backward`` + ``update``
    timed again after the fit, each epoch's perplexities, peak memory
    and, on the card, a profile of one step of the longest bucket."""
    on_card = ctx.device_type == "gpu"
    log = _LogLines()
    logging.getLogger().addHandler(log)
    old_level = logging.getLogger().level
    logging.getLogger().setLevel(logging.INFO)
    if on_card:
        # free what earlier phases left for the collector, so that the
        # fit's peak is measured above what is still held
        gc.collect()
        torch.cuda.empty_cache()
    try:
        zero_all_counts()
        mod, it, run = lstm_bucketing.fit(
            ctx, cfg["vocab"], cfg["num_hidden"], cfg["num_embed"],
            cfg["num_layers"], cfg["batch_size"], epochs, lr=lr,
            sentences=sentences, val_sentences=val_sentences,
            disp_batches=40)
        launches = all_counts()
    finally:
        logging.getLogger().removeHandler(log)
        logging.getLogger().setLevel(old_level)
    if on_card:
        # one step of the longest bucket under the profiler, after fit
        longest = next(b for b in it
                       if b.bucket_key == lstm_bucketing.BUCKETS[-1])

        def step():
            mod.forward_backward(longest)
            mod.update()
        run["profile_longest_bucket"] = profile_device(step, marks={
            "gemm": ("gemm", "Gemm", "cutlass", "xmma"),
            "elementwise": ("elementwise", "vectorized", "reduce")})
    del mod
    batches = run.pop("batches")
    ppl = [e["train_perplexity"] for e in run["epochs"]]
    val = [e.get("validation_perplexity") for e in run["epochs"]]
    by_bucket = {}
    for b in batches[len(batches) // epochs:]:     # past the first epoch
        by_bucket.setdefault(str(b["bucket"]), []).append(b["ms"])
    out = dict(run, train_perplexity=ppl, validation_perplexity=val,
               speedometer=[ln for ln in log.lines if "Speed:" in ln],
               fit_batch_ms_median={k: float(np.median(v))
                                    for k, v in sorted(by_bucket.items())},
               first_batch_ms_with_bind=_first_batches(batches),
               kernel_launches=launches, tol_perplexity=bound)
    if on_card:
        out["nvidia_smi"] = nvidia_smi()
        torch.cuda.empty_cache()
    n_buckets = len(lstm_bucketing.BUCKETS)
    bad = []
    if run["binds"] != n_buckets or run["buckets_bound"] != \
            lstm_bucketing.BUCKETS:
        bad.append("%d binds of buckets %s; want one for each of %s"
                   % (run["binds"], run["buckets_bound"],
                      lstm_bucketing.BUCKETS))
    if run["epochs"][0]["binds_so_far"] != run["binds"] or \
            run["binds_while_timing"]:
        bad.append("binds after the first epoch")
    if not all(run["sharing"].values()):
        bad.append("buckets do not share %s" % [
            k for k, v in run["sharing"].items() if not v])
    if not np.isfinite(ppl).all() or not all(
            b < a for a, b in zip(ppl, ppl[1:])):
        bad.append("the perplexity did not fall from epoch to epoch")
    if not (ppl[-1] < bound and val[-1] is not None and val[-1] < bound):
        bad.append("the last epoch's train and validation perplexities "
                   "%r and %r are not below %r" % (ppl[-1], val[-1], bound))
    if any(launches.values()):
        bad.append("kernels launched on the bucketing path: %s" % launches)
    if bad:
        raise SystemExit("bucketing_train: %s: %s" % ("; ".join(bad),
                                                       json.dumps(out)))
    return out


def _bucket_batches(cfg, n, seed=1):
    """The iterator of a seeded successor corpus at ``cfg``'s vocabulary
    and batch, and its first batches of ``n`` different buckets."""
    corpus = lstm_bucketing.successor_corpus(
        cfg["batch_size"] * 30, cfg["vocab"], lstm_bucketing.SUPPORT, seed)
    random.seed(seed)
    np.random.seed(seed)
    it = mx.rnn.BucketSentenceIter(corpus, cfg["batch_size"],
                                   buckets=list(lstm_bucketing.BUCKETS),
                                   invalid_label=lstm_bucketing.INVALID_LABEL)
    picked = {}
    for b in it:
        picked.setdefault(b.bucket_key, b)
        if len(picked) == n:
            break
    return it, list(picked.values())


def _bucketing_module(cfg, it, ctx):
    mod = mx.mod.BucketingModule(
        lstm_bucketing.lstm_sym_gen(cfg["vocab"], cfg["num_hidden"],
                                    cfg["num_embed"], cfg["num_layers"]),
        default_bucket_key=it.default_bucket_key, context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    return mod


def bucketing_check_phase(ctx, cfg=BUCKET_CHECK, steps=BUCKET_CHECK_STEPS,
                          lr=0.1, check_ctx=None):
    """``steps`` SGD steps (momentum 0.9, wd 1e-5) of the bucketing LM at
    ``cfg``'s narrow width, one batch of each of ``steps`` buckets, on
    ``ctx`` and on ``check_ctx`` (default: the CPU) from the same Xavier
    weights and batches; per parameter the changes agree within
    ``TOL_BUCKETING_CHECK`` (:func:`update_diff`), and on the card the same
    steps with TF32 matmuls, run as a control, must miss it."""
    check_ctx = check_ctx or mx.cpu()
    it, batches = _bucket_batches(cfg, steps)
    ref = _bucketing_module(cfg, it, mx.cpu())
    ref.init_params(initializer=mx.init.Xavier(factor_type="in",
                                               magnitude=2.34, rng=0))
    weights = {k: v.asnumpy().copy() for k, v in ref.get_params()[0].items()}
    del ref

    def run(c, tf32=False):
        mod = _bucketing_module(cfg, it, c)
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in weights.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": lr, "momentum": 0.9, "wd": 1e-5})
        ppl = []
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            for b in batches:
                mod.forward_backward(b)
                mod.update()
                m = mx.metric.Perplexity(lstm_bucketing.INVALID_LABEL)
                m.update(b.label, mod.get_outputs())
                ppl.append(m.get()[1])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        after = mod.get_params()[0]
        return ppl, {k: torch.from_numpy(after[k].asnumpy() - w)
                     for k, w in weights.items()}

    ppl, delta = run(ctx)
    ref_ppl, ref_delta = run(check_ctx)
    out = {"config": cfg, "steps": steps,
           "buckets": [b.bucket_key for b in batches], "optimizer": "sgd",
           "learning_rate": lr, "momentum": 0.9,
           "contexts": [str(ctx), str(check_ctx)],
           "perplexity": [ppl, ref_ppl],
           **update_diff(delta, ref_delta, True),
           "tol": TOL_BUCKETING_CHECK, "control_tf32": None}
    if ctx.device_type == "gpu":
        tf32_ppl, tf32_delta = run(ctx, tf32=True)
        out["control_tf32"] = dict(update_diff(tf32_delta, ref_delta),
                                   perplexity=tf32_ppl)
    if out["max_rel_update_diff"] > TOL_BUCKETING_CHECK \
            or not np.isfinite(ppl + ref_ppl).all():
        raise SystemExit("bucketing_check: %s" % json.dumps(out))
    if out["control_tf32"] is not None and \
            out["control_tf32"]["max_rel_update_diff"] <= TOL_BUCKETING_CHECK:
        raise SystemExit("bucketing_check: the TF32 control passes the "
                         "bound, so the bound cannot tell it from f32: %s"
                         % json.dumps(out))
    return out


def _rel_err(x, ref):
    return (x - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


def fused_vs_unfused(ctx, mode, hidden, layers, bidirectional, batch, seq,
                     in_size, seed=0, repeats=0):
    """The RNN op (``FusedRNNCell``) and its ``unfuse()``'d cells on the
    same random flat weights, input and head gradient on ``ctx``: the
    largest relative error of the output, the input gradient and the
    weight gradient (the cells' packed into the flat layout), and with
    ``repeats`` the median ms of forward + backward of each."""
    fused = mx.rnn.FusedRNNCell(hidden, num_layers=layers, mode=mode,
                                bidirectional=bidirectional,
                                prefix="%s_" % mode)
    unfused = fused.unfuse()
    data = mx.sym.Variable("data")
    graphs = {"fused": fused.unroll(seq, data, merge_outputs=True)[0],
              "unfused": unfused.unroll(seq, data, merge_outputs=True)[0]}
    rng = np.random.RandomState(seed)
    pname = "%s_parameters" % mode
    vec = rng.uniform(-1, 1, rnn_param_size(
        mode, in_size, hidden, layers, bidirectional)).astype(np.float32) \
        / np.sqrt(hidden)
    x = rng.normal(0, 1, (batch, seq, in_size)).astype(np.float32)
    args = {"fused": {pname: vec},
            "unfused": {k: v.asnumpy() for k, v in unfused.pack_weights(
                fused.unpack_weights({pname: vec})).items()}}
    dirs = 2 if bidirectional else 1
    head = rng.normal(0, 1, (batch, seq, hidden * dirs)).astype(np.float32)
    res, ms = {}, {}
    for kind, net in graphs.items():
        given = dict(args[kind], data=x)
        arrays = {n: mx.nd.array(given[n], ctx=ctx)
                  for n in net.list_arguments()}
        exe = net.bind(ctx, arrays)

        def step():
            exe.forward(is_train=True)
            exe.backward([mx.nd.array(head, ctx=ctx)])
        step()
        res[kind] = (exe.outputs[0].data.cpu(),
                     {n: g.data.cpu() for n, g in exe.grad_dict.items()})
        if repeats:
            times = []
            for _ in range(repeats):
                if ctx.device_type == "gpu":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                if ctx.device_type == "gpu":
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[kind] = float(np.median(times))
    (fo, fg), (uo, ug) = res["fused"], res["unfused"]
    packed = fused.pack_weights(unfused.unpack_weights(
        {n: mx.nd.NDArray(g) for n, g in ug.items() if n != "data"}))
    out = {"mode": mode, "hidden": hidden, "layers": layers,
           "bidirectional": bidirectional, "batch": batch, "seq": seq,
           "input": in_size,
           "err_out": _rel_err(fo, uo),
           "err_grad_data": _rel_err(fg["data"], ug["data"]),
           "err_grad_weights": _rel_err(fg[pname],
                                        packed[pname].data.reshape(-1))}
    if repeats:
        out["fwd_bwd_ms"] = ms
    return out


#: rnn_ops' small cases: GRU, bidirectional and the vanilla modes
RNN_SMALL_CASES = [("gru", 16, 2, False), ("gru", 16, 2, True),
                   ("lstm", 16, 2, True), ("rnn_tanh", 16, 2, True),
                   ("rnn_relu", 16, 1, False)]


def rnn_ops_phase(ctx, cfg=LSTM_FULL, seq=60, small_seq=12, repeats=3):
    """The RNN op against the same weights unfused into step cells
    (:func:`fused_vs_unfused`): the lstm_bucketing LSTM at ``cfg``'s full
    width and the longest bucket, with both routes' times, then
    ``RNN_SMALL_CASES`` at batch 4; each within ``TOL_RNN_OPS``."""
    cases = [fused_vs_unfused(ctx, "lstm", cfg["num_hidden"],
                              cfg["num_layers"], False, cfg["batch_size"],
                              seq, cfg["num_embed"], repeats=repeats)]
    cases += [fused_vs_unfused(ctx, mode, h, layers, bi, 4, small_seq, 8,
                               seed=i + 1)
              for i, (mode, h, layers, bi) in enumerate(RNN_SMALL_CASES)]
    out = {"cases": cases, "tol": TOL_RNN_OPS}
    if ctx.device_type == "gpu":
        out["nvidia_smi"] = nvidia_smi()
    bad = [c for c in cases if not max(
        c["err_out"], c["err_grad_data"], c["err_grad_weights"])
        <= TOL_RNN_OPS]
    if bad:
        raise SystemExit("rnn_ops: %s" % json.dumps(out))
    return out


def _hinge_margins(scores, labels):
    """Per row, 1 + s_j - s_label for every class j, 0 at the label."""
    s = scores.asnumpy()
    lab = labels.asnumpy().astype(np.int64)
    rows = np.arange(s.shape[0])
    margin = 1 + s - s[rows, lab][:, None]
    margin[rows, lab] = 0
    return margin, rows, lab


def mc_hinge_grad(scores, labels):
    """The Crammer-Singer multiclass hinge subgradient of
    ``examples/module_api/python_loss.py``, over the batch at once."""
    margin, rows, lab = _hinge_margins(scores, labels)
    grad = np.zeros_like(margin)
    grad[rows, lab] -= 1
    np.add.at(grad, (rows, margin.argmax(1)), 1)
    return grad / len(rows)


def hinge_loss(scores, labels):
    """The batch's mean multiclass hinge loss."""
    return float(_hinge_margins(scores, labels)[0].max(1).mean())


#: the Monitor's outputs in module_api: each LSTM layer's tanh(c) at every
#: step, the head and the softmax
MONITOR_PATTERN = r"lstm_l\d+_t\d+_state_output|pred_output|softmax_output"


def module_api_phase(ctx, n=2000, batch=100, dim=196, monitor_cfg=
                     BUCKET_CHECK):
    """``examples/module_api/python_loss.py`` on ``ctx``: an MLP ``Module``
    chained by ``SequentialModule`` into a ``PythonLossModule`` whose
    gradient is the numpy hinge subgradient, ``fit`` for one epoch of
    ``n / batch`` batches (Xavier, SGD lr 0.1 momentum 0.9); the hinge loss
    of each batch's outputs must fall (the last four batches' mean below the
    first's).  Then a ``Monitor`` on ``MONITOR_PATTERN`` installed on one
    bucket's executor of a bucketing LM at ``monitor_cfg``'s width gives
    its statistics for one batch, all of them in the phase's line: one for
    every op output of that bucket's graph the pattern matches, all
    finite, and none from another bucket's batch."""
    protos = np.random.RandomState(42).rand(10, dim).astype("f")
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, n)
    x = (protos[y] + 0.25 * rng.randn(n, dim).astype("f")).astype("f")
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, name="fc1", num_hidden=128)
    act1 = mx.sym.Activation(fc1, name="relu1", act_type="relu")
    fc2 = mx.sym.FullyConnected(act1, name="fc2", num_hidden=64)
    act2 = mx.sym.Activation(fc2, name="relu2", act_type="relu")
    fc3 = mx.sym.FullyConnected(act2, name="fc3", num_hidden=10)
    mlp = mx.mod.Module(fc3, label_names=[], context=ctx)
    loss = mx.mod.PythonLossModule(grad_func=mc_hinge_grad)
    seq = mx.mod.SequentialModule().add(mlp).add(
        loss, take_labels=True, auto_wiring=True)
    np.random.seed(0)
    it = mx.io.NDArrayIter(x, y.astype("f"), batch, shuffle=True)
    losses, stamps = [], [time.perf_counter()]

    def record(param):
        b = param.locals["batch"]
        losses.append(hinge_loss(seq.get_outputs()[0], b.label[0]))
        stamps.append(time.perf_counter())
    seq.fit(it, num_epoch=1, initializer=mx.init.Xavier(rng=0),
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            batch_end_callback=record)
    out = {"batches": len(losses), "batch": batch, "hinge_loss": losses,
           "batch_ms": [(b - a) * 1e3 for a, b in
                        zip(stamps[1:], stamps[2:])],
           "output_context": str(seq.get_outputs()[0].context)}

    mit, batches = _bucket_batches(monitor_cfg, 2)
    mod = _bucketing_module(monitor_cfg, mit, ctx)
    mod.init_params(initializer=mx.init.Xavier(rng=0))
    mod.init_optimizer(optimizer="sgd")
    watched, other = batches
    mod.prepare(watched)
    mon = mx.Monitor(1, pattern=MONITOR_PATTERN)
    mon.install(mod._buckets[watched.bucket_key]._exec_group.execs[0])
    mon.tic()
    mod.forward_backward(watched)
    mod.update()
    mod.forward_backward(other)
    mod.update()
    stats = mon.toc()
    for step, name, value in stats:
        logging.info("Batch: %7d %30s %s", step, name, value)
    graph = mod._buckets[watched.bucket_key].symbol
    pattern = re.compile(MONITOR_PATTERN)
    n_ops = sum(1 for node in graph._topo() if node.op is not None
                for name in node.output_names() if pattern.match(name))
    values = [float(v.split("\t")[0]) for _s, _n, v in stats]
    out["monitor"] = {"pattern": MONITOR_PATTERN,
                      "bucket": watched.bucket_key,
                      "other_bucket": other.bucket_key,
                      "stats": len(stats), "op_outputs": n_ops,
                      "triples": stats}
    if ctx.device_type == "gpu":
        out["nvidia_smi"] = nvidia_smi()
    bad = []
    if not (np.isfinite(losses).all()
            and np.mean(losses[-4:]) < losses[0]):
        bad.append("the hinge loss did not fall")
    if out["output_context"] != str(ctx):
        bad.append("the outputs lie on %s" % out["output_context"])
    if len(stats) != n_ops or not np.isfinite(values).all():
        bad.append("%d monitor statistics for %d op outputs"
                   % (len(stats), n_ops))
    if bad:
        raise SystemExit("module_api: %s: %s" % ("; ".join(bad),
                                                  json.dumps(out)))
    return out


# ------------------------------------------------------------- ResNet-50
def k5_bound(m, k, n, dtype, f32_values=None):
    """Least time for one K5 launch on this card: the larger of 2MNK
    flops over the route's peak and the bytes it must move (x, w, y in the
    dtype; ``f32_values`` more in f32, default 3N: c read, s1 and s2
    written) over HBM bandwidth.  bf16 runs on the bf16 tensor cores; f32
    runs each product as three TF32 products (split TF32), so its bound is
    3 x flops at 495 TFLOP/s (also ``bound_split_tf32_ms``), with
    ``bound_cuda_core_ms`` beside it, the bound of f32 FMAs on the CUDA
    cores, which an earlier f32 kernel ran and the kernel table keeps."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    flops = 2.0 * m * n * k
    f32_values = 3 * n if f32_values is None else f32_values
    nbytes = float(itemsize) * (m * k + n * k + m * n) + 4.0 * f32_values
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if dtype == torch.float32:
        t_ops = 3.0 * flops / TF32_FLOPS * 1e3
        peak = PEAK_NAME["split_tf32"]
    else:
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        peak = PEAK_NAME[dtype]
    out = {"flops": flops, "bytes": nbytes,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "peak": peak + ", HBM 3.35 TB/s"}
    if dtype == torch.float32:
        out.update(bound_split_tf32_ms=out["bound_ms"],
                   bound_split_tf32_by=out["bound_by"],
                   bound_cuda_core_ms=max(
                       flops / PEAK_FLOPS[torch.float32] * 1e3, t_bytes))
    return out


def k5_library(x, w_nk, c):
    """The yardstick: cuBLAS ``x @ w^T``, then ``torch.sum`` of ``(y - c)``
    and of its square over the rows, in f32."""
    y = x @ w_nk.t()
    ys = y.float() - c
    return y, ys.sum(0), (ys * ys).sum(0)


def k5_check(y, s1, s2, ry, rs1, rs2):
    """K5's criteria: a bf16 y within one bf16 ulp of the plain y plus
    TOL_K5_Y_F32 of its largest entry, an f32 y within TOL_K5_Y_F32 of its
    largest entry; s1 and s2 by relative norm TOL_K5_SUMS."""
    dy = (y.float() - ry.float()).abs()
    ref_max = ry.float().abs().max().item()
    out = {"max_abs_err": dy.max().item(), "y_ref_max": ref_max,
           "y_rel_norm": (dy.norm() / ry.float().norm()).item()}
    if y.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            ry.float().abs().clamp_min(1e-30))) - 7)
        out["y_over_one_ulp"] = int((dy > ulp).sum().item())
        out["y_over_tol"] = int(
            (dy > ulp + TOL_K5_Y_F32 * ref_max).sum().item())
        ok = out["y_over_tol"] == 0
    else:
        out["y_tol"] = TOL_K5_Y_F32 * ref_max
        ok = out["max_abs_err"] <= out["y_tol"]
    for name, got, ref in (("s1", s1, rs1), ("s2", s2, rs2)):
        got, ref = got.reshape(-1), ref.reshape(-1)
        out[name + "_max_abs_err"] = (got - ref).abs().max().item()
        out[name + "_rel_norm"] = ((got - ref).norm() / ref.norm()).item()
        ok = ok and out[name + "_rel_norm"] <= TOL_K5_SUMS
    out["ok"] = ok
    return out


def identical(first, second):
    """True when two launches' outputs are bit-identical."""
    return all(torch.equal(a, b) for a, b in zip(first, second))


def k5_times(fn, dot):
    """A K5, K7 or K8 launch's times: ``kernel_ms`` by CUDA events around
    20 calls (the wrapper's host time included where it exceeds the
    card's), ``device_ms`` from the replay of a CUDA graph of 20 launches
    (the card's alone), ``host_us`` the wrapper's host time a call, and
    ``dot_ms``, cuBLAS's bare product ``dot`` at the same shape, timed as
    ``device_ms``."""
    return {"kernel_ms": cuda_ms(fn, 20),
            "device_ms": matmul_stats_experiment.device_ms(fn),
            "host_us": matmul_stats_experiment.host_us(fn),
            "dot_ms": matmul_stats_experiment.device_ms(dot)}


def resnet_kernels_phase():
    """K5 (``matmul_stats``) against ``matmul_stats_plain`` on the card at
    the bench configuration's 8 shapes in bf16, 2 of them in f32 and the
    cuda tests' shapes off the path (``K5_ODD_SHAPES``, bf16 and f32): the
    weight is read as the OIHW (N, K) tensor lies, through its transpose.
    Two launches on the same inputs must give bit-identical y, s1 and s2;
    a shape TMA does not take (K or N not a multiple of 16 bytes) must go
    through the wrapper's padding (``matmul_stats.padded``), the others
    not."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(m, k, n, torch.bfloat16, count)
             for m, k, n, count in K5_BENCH_SHAPES]
    cases += [(m, k, n, torch.float32, 0) for m, k, n in K5_F32_SHAPES]
    cases += [(m, k, n, dt, 0) for m, k, n in K5_ODD_SHAPES
              for dt in (torch.bfloat16, torch.float32)]
    entries = []
    for m, k, n, dt, count in cases:
        x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        w_nk = (torch.randn(n, k, generator=gen, device="cuda")
                / k ** 0.5).to(dt)
        w2d = w_nk.t()
        c = 0.1 * torch.randn(n, generator=gen, device="cuda")
        matmul_stats.padded = 0
        out = matmul_stats(x, w2d, c)
        torch.cuda.synchronize()
        padded = matmul_stats.padded
        entry = {"shape": [m, k, n], "dtype": str(dt).replace("torch.", ""),
                 "launches_per_step": count, "padded": padded,
                 "bit_identical": identical(out, matmul_stats(x, w2d, c))}
        entry.update(k5_check(*out, *matmul_stats_plain(x, w2d, c)))
        del out
        # TMA's 16-byte row strides: 8 bf16 or 4 f32 values
        q = 8 if dt == torch.bfloat16 else 4
        want_pad = bool(k % q or n % q)
        entry["ok"] = entry["ok"] and entry["bit_identical"] \
            and padded == (1 if want_pad else 0)
        entry["tol_sums"] = TOL_K5_SUMS
        if count:
            entry.update(k5_times(lambda: matmul_stats(x, w2d, c),
                                  lambda: x @ w2d))
            entry.update(
                plain_ms=cuda_ms(lambda: matmul_stats_plain(x, w2d, c), 3),
                library_ms=cuda_ms(lambda: k5_library(x, w_nk, c), 20))
        elif dt == torch.float32 and [m, k, n] in map(list, K5_F32_SHAPES):
            # dot_ms: cuBLAS's f32 x @ w, TF32 off (env_phase)
            entry.update(
                kernel_ms=cuda_ms(lambda: matmul_stats(x, w2d, c), 20),
                device_ms=matmul_stats_experiment.device_ms(
                    lambda: matmul_stats(x, w2d, c)),
                dot_ms=matmul_stats_experiment.device_ms(lambda: x @ w2d),
                plain_ms=cuda_ms(lambda: matmul_stats_plain(x, w2d, c), 3),
                library_ms=cuda_ms(lambda: k5_library(x, w_nk, c), 20))
        entry.update(k5_bound(m, k, n, dt))
        entries.append(entry)
        del x, w_nk, w2d, c
    emit("kernels", name="matmul_stats", entries=entries,
         host=matmul_stats_experiment.host_costs())
    bad = [e for e in entries if not e["ok"]]
    if bad:
        raise SystemExit("matmul_stats disagrees with its plain version, "
                         "differs between two launches or took the wrong "
                         "route: %s" % json.dumps(bad))
    return entries


def resnet_train_phase(ctx, batch=128, image=224, dtype="bfloat16",
                       steps=10, timed_steps=5, repeats=2, blocks=50,
                       k5_blocks=16, learning_rate=0.1):
    """The bench configuration (``tools.bench.build_trainer``: ResNet-50
    v2, SGD momentum 0.9, lr 0.1, weight decay 1e-4, NHWC, block fusion)
    on ``ctx``: one warm-up step, then ``steps`` steps of ``run_steps``
    with K5's count set to 0 just before and read just after.  Every loss
    finite and the last below the first; every moving statistic moved;
    the plan ``blocks`` blocks with ``k5_blocks`` on K5, each launching
    once a step.  Then the best of ``repeats`` timed chains of
    ``timed_steps``, peak memory, and a profiled step."""
    on_card = ctx.device_type == "gpu"
    t0 = time.perf_counter()
    trainer, staged = build_resnet_trainer(
        batch, image, dtype=dtype, learning_rate=learning_rate, ctx=ctx)
    build_s = time.perf_counter() - t0

    def sync():
        if on_card:
            torch.cuda.synchronize()

    warm = float(trainer.step(staged))
    aux_before = {k: v.clone() for k, v in trainer.aux.items()}
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    matmul_stats.launches = 0
    matmul_stats.padded = 0
    t0 = time.perf_counter()
    losses = trainer.run_steps(staged, steps).tolist()
    sync()
    steps_s = time.perf_counter() - t0
    launches = matmul_stats.launches
    padded = matmul_stats.padded
    summary = trainer.fusion_summary()
    want = k5_blocks * steps if on_card else 0
    if launches != want:
        raise SystemExit("resnet_train: matmul_stats launched %d times in "
                         "%d steps; want %d" % (launches, steps, want))
    if padded:
        raise SystemExit("resnet_train: %d of matmul_stats's launches went "
                         "through padding; every ResNet-50 shape is one "
                         "TMA takes" % padded)
    if not np.isfinite([warm] + losses).all():
        raise SystemExit("resnet_train: non-finite loss in %s" % losses)
    if not losses[-1] < losses[0]:
        raise SystemExit("resnet_train: loss did not fall over %d steps: "
                         "%s" % (steps, losses))
    still = [k for k, v in aux_before.items()
             if torch.equal(v, trainer.aux[k])]
    if still:
        raise SystemExit("resnet_train: moving statistics unchanged: %s"
                         % still)
    if summary is None or summary["blocks"] != blocks \
            or summary["pallas_blocks"] != k5_blocks:
        raise SystemExit("resnet_train: fusion plan %s; want %d blocks, %d "
                         "on K5" % (summary, blocks, k5_blocks))
    times = []
    for _ in range(repeats):
        _done, seconds, timed = time_chains(trainer, staged, timed_steps,
                                            timed_steps)
        times.append(seconds)
    if not torch.isfinite(timed).all():
        raise SystemExit("resnet_train: non-finite loss in the timed steps")
    step_s = min(times) / timed_steps
    out = {"batch": batch, "image": image, "dtype": dtype,
           "layout": "NHWC", "fuse_blocks": True, "context": str(ctx),
           "optimizer": "sgd", "learning_rate": learning_rate,
           "momentum": 0.9, "weight_decay": 1e-4,
           "params": sum(int(v.numel()) for v in trainer.params.values()),
           "build_s": build_s, "warmup_loss": warm, "steps": steps,
           "losses": losses, "steps_wall_s": steps_s,
           "launches": {"matmul_stats": launches}, "k5_padded": padded,
           "launches_per_step": launches / steps, "fusion": summary,
           "timed_steps": timed_steps, "repeats_s": times,
           "step_ms": step_s * 1e3, "images_per_s": batch / step_s}
    if on_card:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        # after the launch count was read: this step is not counted
        out["profile"] = profile_device(
            lambda: trainer.step(staged), top=15,
            marks={"k5": ("matmul_stats",),
                   "layout_transposes": ("nhwcToNchw", "nchwToNhwc",
                                         "tensorTransform"),
                   "library_convs_gemms": (
                       "xmma", "cudnn", "cutlass", "implicit", "nvjet",
                       "gemm", "conv", "dgrad", "wgrad"),
                   "pytorch_elementwise_reductions": (
                       "elementwise_kernel", "reduce_kernel")})
    return out


def resnet_train_check_phase(ctx, batch=8, image=64, check_ctx=None,
                             k5_blocks=16):
    """One f32 SGD step of ResNet-50 v2 (NHWC, block fusion, K5 in f32) at
    ``batch`` x ``image`` on ``ctx`` and on ``check_ctx`` (default: the
    CPU) from the same seeded weights and batch.  Per parameter and per
    moving statistic, the relative norm of the difference of the two
    changes must stay within ``TOL_RESNET_CHECK`` (parameters) and
    ``TOL_RESNET_CHECK_AUX`` (moving statistics).  On the card the step is
    also run with TF32 convolutions and matmuls as a control, whose worst
    differences must exceed both bounds."""
    check_ctx = check_ctx or mx.cpu()

    def one_step(c, tf32=False):
        trainer, staged = build_resnet_trainer(batch, image,
                                               dtype="float32", ctx=c)
        before = {k: v.to("cpu", copy=True) for k, v in
                  list(trainer.params.items()) + list(trainer.aux.items())}
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        matmul_stats.launches = 0
        try:
            loss = float(trainer.step(staged))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        now = dict(trainer.params, **trainer.aux)
        return loss, matmul_stats.launches, \
            {k: now[k].cpu() - before[k] for k in before}

    def compare(delta, ref, each=False):
        rel = {k: (delta[k] - d).norm().item() / max(d.norm().item(), 1e-30)
               for k, d in ref.items()}
        aux = {k: v for k, v in rel.items()
               if k.endswith(("moving_mean", "moving_var"))}
        par = {k: v for k, v in rel.items() if k not in aux}
        worst = max(par, key=par.get)
        worst_aux = max(aux, key=aux.get)
        out = {"max_rel_update_diff": par[worst], "worst": worst,
               "median_rel_update_diff": float(np.median(list(par.values()))),
               "max_rel_aux_diff": aux[worst_aux], "worst_aux": worst_aux,
               "median_rel_aux_diff": float(np.median(list(aux.values())))}
        if each:
            out["rel_update_diff"] = rel
        return out

    def within(o):
        return o["max_rel_update_diff"] <= TOL_RESNET_CHECK \
            and o["max_rel_aux_diff"] <= TOL_RESNET_CHECK_AUX

    loss, launches, delta = one_step(ctx)
    ref_loss, _n, ref_delta = one_step(check_ctx)
    losses = [loss, ref_loss]
    out = {"model": "resnet50", "batch": batch, "image": image,
           "optimizer": "sgd", "learning_rate": 0.1, "dtype": "float32",
           "contexts": [str(ctx), str(check_ctx)], "losses": losses,
           "k5_launches": launches, "compared": len(ref_delta),
           **compare(delta, ref_delta, True), "tol": TOL_RESNET_CHECK,
           "tol_aux": TOL_RESNET_CHECK_AUX, "control_tf32": None}
    del delta
    on_card = ctx.device_type == "gpu"
    if launches != (k5_blocks if on_card else 0):
        raise SystemExit("resnet_train_check: matmul_stats launched %d "
                         "times in one step" % launches)
    if on_card:
        tf32_loss, _n, tf32_delta = one_step(ctx, tf32=True)
        losses.append(tf32_loss)
        out["control_tf32"] = compare(tf32_delta, ref_delta)
    if not within(out) or not np.isfinite(losses).all():
        raise SystemExit("resnet_train_check: %s" % json.dumps(out))
    control = out["control_tf32"]
    if control is not None and (
            control["max_rel_update_diff"] <= TOL_RESNET_CHECK
            or control["max_rel_aux_diff"] <= TOL_RESNET_CHECK_AUX):
        raise SystemExit("resnet_train_check: the TF32 control passes a "
                         "bound, so the bounds cannot tell it from f32: %s"
                         % json.dumps(out))
    return out


# ------------------------------------------------- the ImageNet input path
#: the record sets made on the card (``io_train_bench.make_class_rec``):
#: (records, seed) of 256-px JPEGs (quality 90) of 4 classes a network can
#: learn, for training, validation and the Module route
IMAGENET_CLASSES = 4
IMAGENET_SIZE = 256
IMAGENET_RECORDS = {"train": (4096, 0), "val": (512, 1), "module": (128, 2)}
#: the 4:4:4 JPEGs (no chroma subsampling) the decode is also held on
IMAGENET_444_RECORDS = (64, 3)
IMAGENET_EPOCHS = 2
IMAGENET_PARITY_STEPS = 3
#: the last epoch's validation accuracy must exceed this: a one-class
#: guess scores 0.25.  On an NVIDIA H100 80GB HBM3 at 700.00 W the first
#: runs read 0.518 and 0.5 after the first epoch and 1.0 after the second
#: (an earlier set of 2048 records, 16 steps an epoch, read 0.25 and
#: 0.531: the moving statistics lag)
TOL_VAL_ACCURACY = 0.75
#: the native decode against PIL's libjpeg on the same records: the mean
#: absolute pixel difference must stay below these, on the 4:2:0 records
#: (where decoders may upsample chroma differently) and on 4:4:4 ones (the
#: IDCT and colour conversion alone); the same decode with its channels
#: reversed, run as a control, must exceed them.  nvJPEG on the host of
#: an NVIDIA H100 80GB HBM3 at 700.00 W read 5.41 (max 47) and 0.50 (max
#: 4), the control 71.9 and 73.2
TOL_DECODE_MEAN = 10.0
TOL_DECODE_MEAN_444 = 2.0
#: batches timed through PIL's ``ImageIter`` (after a first one)
IMAGE_ITER_BATCHES = 4


def make_image_records(workdir, records=None, size=IMAGENET_SIZE):
    """``({name: path}, seconds)``: the record sets of ``records`` (default
    ``IMAGENET_RECORDS``) written under ``workdir``."""
    from mxnet_tpu_torch.tools.io_train_bench import make_class_rec
    t0 = time.perf_counter()
    paths = {}
    for name, (n, seed) in (records or IMAGENET_RECORDS).items():
        paths[name] = os.path.join(workdir, name + ".rec")
        make_class_rec(paths[name], n, size=size, classes=IMAGENET_CLASSES,
                       seed=seed)
    return paths, time.perf_counter() - t0


def _pipeline_images(rec, threads, image, batch):
    """Every image of ``rec`` through the native pipeline (raw uint8, no
    augmentation) as a sorted list of (label, sha1 of its bytes)."""
    import hashlib
    it = mx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, image, image),
                               batch_size=batch, preprocess_threads=threads,
                               raw_uint8=True)
    out = []
    for b in it:
        raw, lab = b.data[0].data.numpy(), b.label[0].data.numpy()
        for i in range(batch - b.pad):
            out.append((float(lab[i]), hashlib.sha1(raw[i]).hexdigest()))
    it.close()
    return sorted(out)


def _decode_against_pil(rec, size, batch=64):
    """The pipeline's decode at the images' own size (no resize: a copy)
    against PIL's (libjpeg-turbo) decode of the same records in order, one
    decode thread: mean and max absolute pixel difference, and the mean
    with the pipeline's channels reversed (a control)."""
    import io as _pyio
    from PIL import Image
    it = mx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, size, size),
                               batch_size=batch, preprocess_threads=1,
                               raw_uint8=True)
    reader = mx.recordio.MXRecordIO(rec, "r")
    total, swapped, count, worst = 0.0, 0.0, 0, 0
    for b in it:
        raw = b.data[0].data.numpy().astype(np.int16)
        for i in range(batch - b.pad):
            _h, payload = mx.recordio.unpack(reader.read())
            ref = np.asarray(Image.open(_pyio.BytesIO(payload))
                             .convert("RGB")).astype(np.int16)
            d = np.abs(raw[i] - ref)
            total += float(d.sum())
            swapped += float(np.abs(raw[i][..., ::-1] - ref).sum())
            count += d.size
            worst = max(worst, int(d.max()))
    it.close()
    reader.close()
    return {"mean_abs": total / count, "max_abs": worst,
            "control_channels_reversed_mean_abs": swapped / count}


def _image_iter_rate(rec, image, batch, batches=IMAGE_ITER_BATCHES):
    """Images/s of PIL's ``ImageIter`` as ``train_imagenet.get_rec_iter``
    builds it for training when the native pipeline is not taken
    (``MXNET_USE_NATIVE_REC=0``): ``batches`` batches after a first one."""
    from mxnet_tpu_torch.tools import train_imagenet
    idx = os.path.splitext(rec)[0] + ".idx"   # ImageIter shuffles by it
    reader = mx.recordio.MXRecordIO(rec, "r")
    with open(idx, "w") as fout:
        key = 0
        while True:
            pos = reader.tell()
            if reader.read() is None:
                break
            fout.write("%d\t%d\n" % (key, pos))
            key += 1
    reader.close()
    args = _imagenet_args(rec, mx.cpu(), 50, image, "--batch-size",
                          str(batch), "--data-train-idx", idx)
    before = os.environ.get("MXNET_USE_NATIVE_REC")
    os.environ["MXNET_USE_NATIVE_REC"] = "0"
    try:
        it, _val = train_imagenet.get_rec_iter(args, mx.kvstore.create())
    finally:
        if before is None:
            del os.environ["MXNET_USE_NATIVE_REC"]
        else:
            os.environ["MXNET_USE_NATIVE_REC"] = before
    if type(it).__name__ != "ImageIter":
        raise SystemExit("image_io: get_rec_iter gave %s, not ImageIter"
                         % type(it).__name__)
    it.reset()
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    return batches * batch / (time.perf_counter() - t0)


def image_io_phase(recs, image=224, batch=128, size=IMAGENET_SIZE):
    """The decoders this host offers (PIL, libjpeg's headers, nvJPEG), the
    port's native library built from ``csrc/host`` (its compiler line and
    time), the native pipeline's images/s (raw uint8, ``image`` square,
    page cache warm) at 1, 2, 4 and the host's core count of decode
    threads, the validation records at one thread against all cores as
    multisets of (label, image), the decode against PIL's on the same
    records, and the images/s of PIL's ``ImageIter``, the tool's route
    where the native pipeline has no decoder."""
    from mxnet_tpu_torch import io_native
    from mxnet_tpu_torch.tools.io_train_bench import decoder_scaling
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    probe = dict(io_native.probe(), pil=pil)
    build = io_native.build_info()
    decoder = io_native.decoder()
    if build is None or not io_native.jpeg_available():
        raise SystemExit("image_io: the native pipeline has no JPEG decoder "
                         "(%s, probe %s)" % (build, probe))
    cores = os.cpu_count() or 1
    rates, loads = decoder_scaling(recs["train"], image, batch)
    one = _pipeline_images(recs["val"], 1, image, batch)
    many = _pipeline_images(recs["val"], cores, image, batch)
    n_val = sum(1 for _ in _records(recs["val"]))
    if len(one) != n_val or one != many:
        raise SystemExit("image_io: %d of %d images at 1 thread, %d at %d; "
                         "the multisets differ"
                         % (len(one), n_val, len(many), cores))
    from mxnet_tpu_torch.tools.io_train_bench import make_class_rec
    rec444 = os.path.join(os.path.dirname(recs["val"]), "val444.rec")
    make_class_rec(rec444, IMAGENET_444_RECORDS[0], size=size,
                   classes=IMAGENET_CLASSES, seed=IMAGENET_444_RECORDS[1],
                   subsampling=0)
    vs_pil = {"4:2:0": _decode_against_pil(recs["val"], size),
              "4:4:4": _decode_against_pil(rec444, size)}
    for key, tol in (("4:2:0", TOL_DECODE_MEAN),
                     ("4:4:4", TOL_DECODE_MEAN_444)):
        got = vs_pil[key]
        if not got["mean_abs"] <= tol \
                < got["control_channels_reversed_mean_abs"]:
            raise SystemExit("image_io: the %s decode against PIL's on %s "
                             "JPEGs: %s, bound %s" % (decoder, key, got, tol))
    image_iter = _image_iter_rate(recs["train"], image, batch)
    return {"probe": probe, "decoder": decoder,
            "build": {k: build[k] for k in ("cmd", "seconds", "cached")},
            "cores": cores, "image": image, "batch": batch,
            "decode_images_per_s": rates, "decode_cpu_per_wall": loads,
            "image_iter_images_per_s": image_iter,
            "multiset_images": len(one), "multiset_equal": True,
            "multiset_threads": [1, cores], "vs_pil": vs_pil,
            "tol_decode_mean": {"4:2:0": TOL_DECODE_MEAN,
                                "4:4:4": TOL_DECODE_MEAN_444}}


def _records(rec):
    reader = mx.recordio.MXRecordIO(rec, "r")
    try:
        while True:
            r = reader.read()
            if r is None:
                return
            yield r
    finally:
        reader.close()


def _imagenet_args(train, ctx, layers, image, *extra):
    from mxnet_tpu_torch.tools import train_imagenet
    return train_imagenet.parser().parse_args(
        ["--network", "resnet", "--num-layers", str(layers),
         "--data-train", train, "--image-shape", "3,%d,%d" % (image, image),
         "--num-classes", "1000", "--data-nthreads",
         str(os.cpu_count() or 1), "--disp-batches", "8"]
        + (["--cpu", "1"] if ctx.device_type == "cpu" else [])
        + list(extra))


def _queue_parity(rec, ctx, layers, image, batch,
                  steps=IMAGENET_PARITY_STEPS):
    """The first ``steps`` batches of ``rec`` (one decode thread, in
    order) through two trainers built alike: one fed by a
    ``DevicePrefetchIter`` (pinned memory, its copy stream and event on the
    card), one staged inline by ``put_batch``.  Losses and every parameter
    and moving statistic must agree to the bit; cuDNN's deterministic
    algorithms are on for both, so that only the staging differs."""
    from mxnet_tpu_torch.tools.io_train_bench import build_trainer
    it = mx.io.ImageRecordIter(path_imgrec=rec,
                               data_shape=(3, image, image),
                               batch_size=batch, preprocess_threads=1,
                               raw_uint8=True)
    batches = [next(it) for _ in range(steps)]
    it.close()
    source = mx.io.NDArrayIter(
        np.concatenate([b.data[0].asnumpy() for b in batches]),
        np.concatenate([b.label[0].asnumpy() for b in batches]),
        batch_size=batch)
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for queued in (True, False):
            trainer = build_trainer(batch, image, layers, ctx=ctx)
            if queued:
                source.reset()
                losses = [trainer.step(b) for b in mx.io.DevicePrefetchIter(
                    source, trainer.put_batch, depth=2)]
            else:
                losses = [trainer.step(trainer.put_batch(
                    {"data": b.data[0].data,
                     "softmax_label": b.label[0].data})) for b in batches]
            state = {k: v.clone() for k, v in
                     list(trainer.params.items()) + list(trainer.aux.items())}
            runs.append((torch.stack(losses).tolist(), state))
            del trainer
            gc.collect()
    finally:
        torch.backends.cudnn.deterministic = False
    (lq, sq), (li, si) = runs
    differ = [k for k in sq if not torch.equal(sq[k], si[k])]
    out = {"steps": steps, "losses_queue": lq, "losses_inline": li,
           "bit_identical": lq == li and not differ,
           "differing_tensors": differ[:5]}
    if not out["bit_identical"]:
        raise SystemExit("imagenet_train: the queued steps differ from the "
                         "inline ones: %s" % json.dumps(out))
    return out


def imagenet_train_phase(ctx, recs, layers=50, image=224, batch=128,
                         epochs=IMAGENET_EPOCHS, dtype="bfloat16",
                         k5_blocks=16, blocks=50, timed_batches=24,
                         tol_accuracy=TOL_VAL_ACCURACY, lr=0.1):
    """``tools.train_imagenet``'s fused route on ``ctx``: ResNet-``layers``
    v2, ``batch``, ``image`` square, ``dtype``, NHWC, block fusion, SGD
    momentum 0.9, ``lr`` (0.1), wd 1e-4, ``epochs`` epochs of the train records
    through the native pipeline (raw uint8, normalized on the device) and
    a ``DevicePrefetchIter`` of depth 2, validation on the held-out
    records after each.  Every count set to 0 before and read after: K5
    launched ``k5_blocks`` times a step on the card (0 on the CPU), every
    other kernel 0 times.  Every loss finite and the last below the first,
    every moving statistic moved, the plan ``blocks`` blocks with
    ``k5_blocks`` on K5, the last validation accuracy above
    ``tol_accuracy``.  Then ``io_train_bench.train_loop`` sequential and
    prefetched on the fit's trainer (end-to-end images/s, per-stage
    walls; prefetched again with 2 decode threads, where the others take
    the host's cores), and the queue against inline staging to the bit."""
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.tools import fit, train_imagenet
    from mxnet_tpu_torch.tools.io_train_bench import train_loop
    on_card = ctx.device_type == "gpu"
    args = _imagenet_args(
        recs["train"], ctx, layers, image, "--data-val", recs["val"],
        "--batch-size", str(batch), "--dtype", dtype, "--fused", "1",
        "--num-epochs", str(epochs), "--lr", str(lr), "--mom", "0.9",
        "--wd", "1e-4", "--top-k", "2", "--device-queue", "1")
    net = get_model("resnet", num_classes=1000, num_layers=layers,
                    image_shape="3,%d,%d" % (image, image))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    history = {}
    zero_all_counts()
    t0 = time.perf_counter()
    trainer = fit.fit(args, net, train_imagenet.get_rec_iter,
                      history=history)
    wall = time.perf_counter() - t0
    counts = all_counts()
    losses = history["losses"]
    steps = len(losses)
    want = k5_blocks * steps if on_card else 0
    if counts["matmul_stats"] != want or any(
            v for k, v in counts.items() if k != "matmul_stats"):
        raise SystemExit("imagenet_train: launches %s over %d steps; want "
                         "matmul_stats %d, the rest 0"
                         % (counts, steps, want))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SystemExit("imagenet_train: losses %s" % losses)
    still = [k for k, v in trainer.aux.items() if torch.equal(
        v, torch.ones_like(v) if k.endswith("moving_var")
        else torch.zeros_like(v))]
    if still:
        raise SystemExit("imagenet_train: moving statistics unchanged: %s"
                         % still)
    fusion = history.get("fusion")
    if fusion is None or fusion["blocks"] != blocks \
            or fusion["pallas_blocks"] != k5_blocks:
        raise SystemExit("imagenet_train: fusion plan %s; want %d blocks, "
                         "%d on K5" % (fusion, blocks, k5_blocks))
    val = history["epochs"][-1]["val"]
    if not val["accuracy"] > tol_accuracy:
        raise SystemExit("imagenet_train: validation accuracy %s, bound %s"
                         % (val, tol_accuracy))
    out = {"network": "resnet%d" % layers, "batch": batch, "image": image,
           "dtype": dtype, "layout": "NHWC", "fuse_blocks": True,
           "context": str(ctx), "queue_depth": 2, "optimizer": "sgd",
           "learning_rate": lr, "momentum": 0.9, "weight_decay": 1e-4,
           "epochs": epochs, "decoder": mx.io_native.decoder(),
           "steps": steps, "losses": losses,
           "epochs_detail": history["epochs"],
           "stage_walls_s": history["timings"], "fusion": fusion,
           "launches": {"matmul_stats": counts["matmul_stats"]},
           "launches_per_step": counts["matmul_stats"] / steps,
           "tol_val_accuracy": tol_accuracy, "fit_wall_s": wall}
    if on_card:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["sequential"], out["prefetched"], out["prefetched_2_threads"] = (
        train_loop(recs["train"], image, batch, timed_batches, trainer,
                   prefetch_depth=d, threads=t)
        for d, t in ((0, None), (2, None), (2, 2)))
    del trainer
    gc.collect()
    out["queue_parity"] = _queue_parity(recs["train"], ctx, layers, image,
                                        batch)
    return out


def imagenet_module_phase(ctx, recs, layers=50, image=224, batch=32):
    """``tools.train_imagenet --fused 0`` (``Module.fit``) on ``ctx`` with
    ``MXNET_FUSE_BLOCKS=1``: ResNet-``layers`` in f32 NCHW at ``batch``
    for one epoch of the module records (float NCHW batches from the
    native pipeline).  The executors' plan (read after the fit) has blocks
    and none on K5, whose count, like every kernel's, stays 0 (K5 is an
    NHWC route); ms per batch between batch ends, each after a
    synchronize."""
    from mxnet_tpu_torch.analysis import fusion as _fusion
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.tools import fit, train_imagenet
    on_card = ctx.device_type == "gpu"
    args = _imagenet_args(
        recs["module"], ctx, layers, image, "--batch-size", str(batch),
        "--dtype", "float32", "--fused", "0", "--num-epochs", "1",
        "--lr", "0.1")
    net = get_model("resnet", num_classes=1000, num_layers=layers,
                    image_shape="3,%d,%d" % (image, image))
    marks = []

    def batch_end(param):
        if on_card:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    prev = os.environ.get("MXNET_FUSE_BLOCKS")
    os.environ["MXNET_FUSE_BLOCKS"] = "1"
    zero_all_counts()
    try:
        t0 = time.perf_counter()
        fit.fit(args, net, train_imagenet.get_rec_iter,
                batch_end_callback=batch_end)
        wall = time.perf_counter() - t0
    finally:
        if prev is None:
            del os.environ["MXNET_FUSE_BLOCKS"]
        else:
            os.environ["MXNET_FUSE_BLOCKS"] = prev
    counts = all_counts()
    plan = _fusion.last_plan_summary()
    if any(counts.values()):
        raise SystemExit("imagenet_module: launches %s; want 0 (K5 takes "
                         "NHWC only)" % counts)
    if plan is None or not plan["blocks"] or plan["pallas_blocks"] \
            or plan["layout"] != "NCHW":
        raise SystemExit("imagenet_module: fusion plan %s" % plan)
    ms = np.diff(marks) * 1e3
    return {"network": "resnet%d" % layers, "batch": batch,
            "image": image, "dtype": "float32", "layout": "NCHW",
            "context": str(ctx), "MXNET_FUSE_BLOCKS": "1",
            "batches": len(marks), "fusion": plan,
            "launches": {"matmul_stats": counts["matmul_stats"]},
            "ms_per_batch": ms.tolist(),
            "median_ms_per_batch": float(np.median(ms)),
            "fit_wall_s": wall}


# ------------------------------------------------- mx.rtc and experiments
#: the flows of the JAX package's tests/test_rtc.py in CUDA C, with their
#: callable (plain) forms: (name, CUDA C body, inputs, output shape, grid,
#: block, callable); the abs bodies read their element count from ``%d``
RTC_ABS = """
int i = blockIdx.x * blockDim.x + threadIdx.x;
if (i < %d) y[i] = fabsf(x[i]);
"""

#: abs as a CUDA programmer writes it for this card: a grid-stride loop
#: of 16-byte loads and stores (x and y 16-byte aligned), four loads in
#: flight a thread before their stores, then the rest of the float4s and
#: the n % 4 tail
RTC_ABS_VEC = """
const int n = %d;
const int n4 = n / 4;
const int stride = gridDim.x * blockDim.x;
const float4* x4 = reinterpret_cast<const float4*>(x);
float4* y4 = reinterpret_cast<float4*>(y);
int i = blockIdx.x * blockDim.x + threadIdx.x;
for (; i + 3 * stride < n4; i += 4 * stride) {
  float4 v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = x4[i + u * stride];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    y4[i + u * stride] = make_float4(fabsf(v[u].x), fabsf(v[u].y),
                                     fabsf(v[u].z), fabsf(v[u].w));
}
for (; i < n4; i += stride) {
  const float4 v = x4[i];
  y4[i] = make_float4(fabsf(v.x), fabsf(v.y), fabsf(v.z), fabsf(v.w));
}
for (i = n4 * 4 + blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
  y[i] = fabsf(x[i]);
"""


def _rtc_abs(x_ref, y_ref):
    y_ref[:] = torch.abs(x_ref)


def _rtc_muladd(a_ref, b_ref, out_ref):
    out_ref[:] = a_ref * b_ref + 1.0


def _rtc_rowscale(x_ref, y_ref):
    i = mx.rtc.program_id(0)
    y_ref[i, :] = x_ref[i, :] * (i + 1)


def rtc_flows(full=True):
    """The three flows of ``tests/test_rtc.py`` (inputs as there) and abs
    written as a CUDA programmer writes it (``rtc_abs_vec``); with
    ``full``, both abs bodies over an (8192, 8192) f32 array from a seed,
    the vectorised one on eight blocks of 256 an SM."""
    x = np.random.RandomState(0).randn(100, 10).astype("f")
    a = np.arange(64, dtype="f").reshape(8, 8)
    b = np.ones((8, 8), "f") * 2
    flows = [
        ("rtc_abs", RTC_ABS % x.size, [("x", x)], ("y", x.shape),
         (4, 1, 1), (256, 1, 1), _rtc_abs),
        ("muladd", "int i = threadIdx.x;\nout[i] = a[i] * b[i] + 1.0f;",
         [("a", a), ("b", b)], ("out", a.shape), (1, 1, 1), (64, 1, 1),
         _rtc_muladd),
        ("rowscale", "int i = blockIdx.x * 128 + threadIdx.x;\n"
         "y[i] = x[i] * (float)(blockIdx.x + 1);",
         [("x", np.ones((4, 128), "f"))], ("y", (4, 128)), (4, 1, 1),
         (128, 1, 1), _rtc_rowscale),
        ("rtc_abs_vec", RTC_ABS_VEC % x.size, [("x", x)], ("y", x.shape),
         (4, 1, 1), (256, 1, 1), _rtc_abs)]
    if full:
        big = np.random.default_rng(3).standard_normal(
            (8192, 8192), dtype=np.float32)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        flows += [
            ("rtc_abs_full", RTC_ABS % big.size, [("x", big)],
             ("y", big.shape), (big.size // 256, 1, 1), (256, 1, 1),
             _rtc_abs),
            ("rtc_abs_vec_full", RTC_ABS_VEC % big.size, [("x", big)],
             ("y", big.shape), (8 * sms, 1, 1), (256, 1, 1), _rtc_abs)]
    return flows


def rtc_phase():
    """K6: each flow of ``rtc_flows`` compiled from CUDA C by
    ``mx.rtc.Rtc`` on ``gpu(0)`` and pushed once, with the launch count set
    to 0 just before and read just after; then each output against the
    callable form's on the same inputs, exactly, and the two full-size abs
    flows (one element a thread, and float4 in a grid-stride loop) timed
    against ``torch.abs`` and their byte bound (read x, write y)."""
    ctx = mx.gpu(0)
    runs = []
    for name, source, ins, (oname, oshape), grid, block, plain in \
            rtc_flows():
        arrays = [(n, mx.nd.array(v, ctx=ctx)) for n, v in ins]
        out = mx.nd.zeros(oshape, ctx=ctx)
        runs.append((name, source, arrays, oname, out, grid, block, plain))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mx.rtc.Rtc.launches = 0
    for name, source, arrays, oname, out, grid, block, _p in runs:
        mx.rtc.Rtc(name, arrays, [(oname, out)], source).push(
            [v for _n, v in arrays], [out], grid, block)
    torch.cuda.synchronize()
    launches = mx.rtc.Rtc.launches
    build_and_run_s = time.perf_counter() - t0
    if launches != len(runs):
        raise SystemExit("rtc_kernels: %d launches for %d pushes"
                         % (launches, len(runs)))
    entries = []
    for name, source, arrays, oname, out, grid, block, plain in runs:
        ref = mx.nd.zeros(out.shape, ctx=ctx)
        mx.rtc.Rtc(name, arrays, [(oname, ref)], plain).push(
            [v for _n, v in arrays], [ref], grid)
        entries.append({"name": name, "shape": list(out.shape),
                        "grid": list(grid), "block": list(block),
                        "exact": bool(torch.equal(out.data, ref.data)),
                        "max_abs_err": (out.data - ref.data).abs().max()
                        .item()})
    for (name, source, arrays, oname, out, grid, block, plain), full in zip(
            runs, entries):
        if not name.endswith("_full"):
            continue
        ins = [v for _n, v in arrays]
        kernel = mx.rtc.Rtc(name, arrays, [(oname, out)], source)
        callable_form = mx.rtc.Rtc(name, arrays, [(oname, out)], plain)
        lib_out = torch.empty_like(out.data)
        nbytes = 2.0 * out.data.numel() * 4
        full.update(
            kernel_ms=cuda_ms(lambda: kernel.push(ins, [out], grid, block),
                              20),
            plain_ms=cuda_ms(lambda: callable_form.push(ins, [out]), 20),
            library_ms=cuda_ms(lambda: torch.abs(ins[0].data, out=lib_out),
                               20),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", peak="HBM 3.35 TB/s")
    out_fields = {"flows": entries, "launches": launches,
                  "build_and_run_s": build_and_run_s}
    emit("rtc_kernels", **out_fields)
    bad = [e for e in entries if not e["exact"]]
    if bad:
        raise SystemExit("rtc: CUDA C and callable forms differ: %s"
                         % json.dumps(bad))
    return out_fields


def matmul_stats_experiment_phase(batch=128, repeats=2, chain=10):
    """K7 and K8: the ``matmul_stats_experiment`` tool's run at ``batch``
    (its own check of K7 against cuBLAS, and its times) with both launch
    counts set to 0 just before and read just after; then, at each shape,
    K7 (``matmul_stats`` with c = 0) and K8 (the prologue variant) against
    their plain versions on the same inputs, and the kernel, plain,
    library (cuBLAS plus ``torch.sum`` passes; for K8 after the eager
    prologue) and bound times."""
    tool = matmul_stats_experiment
    matmul_stats.launches = 0
    matmul_stats_prologue.launches = 0
    rows = tool.experiment(batch, repeats, chain)
    torch.cuda.synchronize()
    launches = {"matmul_stats": matmul_stats.launches,
                "matmul_stats_prologue": matmul_stats_prologue.launches}
    n_shapes = len(tool.shapes(batch))
    want = {"matmul_stats": n_shapes * (2 + repeats * chain),
            "matmul_stats_prologue": n_shapes * (1 + repeats * chain)}
    if launches != want:
        raise SystemExit("matmul_stats_experiment: launches %s; want %s"
                         % (launches, want))
    gen = torch.Generator(device="cuda").manual_seed(4)
    k7, k8 = [], []
    for m, k, n in tool.shapes(batch):
        x = torch.randn(m, k, generator=gen, device="cuda") \
            .to(torch.bfloat16)
        w = (torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5) \
            .to(torch.bfloat16).t()
        scale = torch.rand(1, k, generator=gen, device="cuda") + 0.5
        shift = torch.randn(1, k, generator=gen, device="cuda")
        zero = torch.zeros(n, device="cuda")
        out7 = tool.matmul_stats(x, w)
        out8 = tool.matmul_stats_prologue(x, w, scale, shift)
        e7 = k5_check(*out7, *matmul_stats_plain(x, w, zero))
        e8 = k5_check(*out8, *matmul_stats_prologue_plain(x, w, scale,
                                                          shift))
        e7["bit_identical"] = identical(out7, tool.matmul_stats(x, w))
        e8["bit_identical"] = identical(
            out8, tool.matmul_stats_prologue(x, w, scale, shift))
        del out7, out8
        for e in (e7, e8):
            e["ok"] = e["ok"] and e["bit_identical"]
        e7.update(shape=[m, k, n], **k5_times(
            lambda: tool.matmul_stats(x, w),
            lambda: tool.library_dot_only(x, w)),
            plain_ms=cuda_ms(lambda: matmul_stats_plain(x, w, zero), 3),
            library_ms=cuda_ms(lambda: tool.library_ref(x, w), 20),
            **k5_bound(m, k, n, torch.bfloat16, f32_values=2 * n))
        e8.update(shape=[m, k, n], **k5_times(
            lambda: tool.matmul_stats_prologue(x, w, scale, shift),
            lambda: tool.library_dot_only(x, w)),
            plain_ms=cuda_ms(lambda: matmul_stats_prologue_plain(
                x, w, scale, shift), 3),
            library_ms=cuda_ms(lambda: tool.library_prologue(
                x, w, scale, shift), 20),
            **k5_bound(m, k, n, torch.bfloat16, f32_values=2 * n + 2 * k))
        k7.append(e7)
        k8.append(e8)
        del x, w, scale, shift
    out = {"batch": batch, "tool_rows": rows, "launches": launches,
           "tol_sums": TOL_K5_SUMS, "tol_y": "one bf16 ulp + %g max|y|"
           % TOL_K5_Y_F32, "matmul_stats": k7, "matmul_stats_prologue": k8}
    emit("matmul_stats_experiment", **out)
    bad = [e for e in k7 + k8 if not e["ok"]]
    if bad:
        raise SystemExit("matmul_stats_experiment: a kernel disagrees with "
                         "its plain version or differs between two "
                         "launches: %s" % json.dumps(bad))
    return out


def block_bound(n, cin, cmid, cout, dtype=torch.bfloat16):
    """Least time for one K9 launch: the larger of its flops over the
    route's peak and the bytes it must move (x read and y written, the
    weights read once, in the dtype; the scales and shifts in f32).  bf16
    runs on the bf16 tensor cores; f32 runs each product as split TF32, 3 x
    flops at 495 TFLOP/s."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    flops = 2.0 * n * 56 * 56 * (cin * cmid + 9 * cmid * cmid + cmid * cout)
    nbytes = float(itemsize) * n * 56 * 56 * (cin + cout) \
        + float(itemsize) * (cin * cmid + 9 * cmid * cmid + cmid * cout) \
        + 4.0 * 2 * 3 * max(cin, cmid)
    if dtype == torch.float32:
        t_ops = 3.0 * flops / TF32_FLOPS * 1e3
        peak = PEAK_NAME["split_tf32"]
    else:
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        peak = PEAK_NAME[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "peak": peak + ", HBM 3.35 TB/s"}


#: K9's channel sets at batch 2 beyond the stage-1 sets and the tests'
#: (16, 16, 32): every cmid, a cin whose last 64-channel chunk is partial
#: (48, 80, 208) and a cout whose last chunk of y is 16, 48 or 32 wide
K9_RANGE_SETS = [(48, 48, 80), (32, 32, 112), (208, 16, 48), (80, 48, 160)]
#: sets only the general kernel takes in bf16: the three that raised
#: before it existed (cmid 80; cin 24; cout 272) and a Wide ResNet's
#: stage-1 sets (cmid 128), as block 1 and as blocks 2 and 3
K9_GENERAL_SETS = [(64, 80, 256), (24, 64, 256), (64, 64, 272),
                   (64, 128, 256), (256, 128, 256)]
#: f32 sets besides those: odd counts everywhere, and cmid 256, whose t1
#: rows in f32 leave room for half rows of 28 positions only
K9_GENERAL_F32_EXTRA = [(3, 7, 5), (64, 256, 64)]
#: the general kernel past cmid 256, at batch 1: cmid 512 and 1024 in both
#: dtypes, in tiles of 28 (bf16 512), 14 (f32 512, bf16 1024) and 8 (f32
#: 1024) positions
K9_WIDE_SETS = [((512, 512, 256), torch.float32),
                ((512, 512, 256), torch.bfloat16),
                ((1024, 1024, 256), torch.float32),
                ((1024, 1024, 256), torch.bfloat16)]
#: the general kernel's own plan (``block_experiment.plan``) must take
#: these tiles (output positions of a row): the widest divisor of 56 whose
#: three haloed t1 rows, t2 row and chunk buffers fit a block's 227 KB
K9_TILES = {(64, torch.float32): 56, (192, torch.float32): 56,
            (256, torch.float32): 28, (512, torch.float32): 14,
            (768, torch.float32): 14, (1024, torch.float32): 8,
            (2048, torch.float32): 4, (256, torch.bfloat16): 56,
            (512, torch.bfloat16): 28, (1024, torch.bfloat16): 14,
            (2048, torch.bfloat16): 8}
#: past the general kernel's limits: refused in both dtypes
K9_REFUSED = (64, 4096, 256)


def block_experiment_phase(batch=128, repeats=5, f32_repeats=2):
    """K9, both routes.  The ``block_experiment`` tool's run at ``batch``
    with its defaults (bf16: the wgmma kernel; its own error against
    ``library_block``, and its times), and again in f32 (the general
    kernel), each with both launch counts set to 0 just before and read
    just after.  Then at both stage-1 channel sets, batch 128, in bf16 and
    in f32: K9 against ``block_plain`` on other seeded inputs, two launches
    bit-identical, the kernel's plan, the card's time (``device_ms``, a
    CUDA graph's replay), the wall a call (``kernel_ms``), the wrapper's
    host time, plain, library and bound; in f32 also the plain version
    with TF32 matmuls as a control, which must miss ``TOL_BLOCK_F32``.  At
    batch 2: every divisor of 56 as ``rows`` at (16, 16, 32), the same
    bits each time; every band height the wgmma kernel can be held to
    (``BANDS``) at (16, 16, 32) and both stage-1 sets; the channel sets of
    ``K9_RANGE_SETS``; the general kernel on ``K9_GENERAL_SETS`` in bf16
    and on those, ``K9_RANGE_SETS``, the tests' set and
    ``K9_GENERAL_F32_EXTRA`` in f32; at batch 1 the sets of
    ``K9_WIDE_SETS`` (cmid 512 and 1024); each against ``block_plain`` and
    bit-identical across two launches, through the route it should take.
    The general kernel's plan must take the tile of ``K9_TILES`` at each of
    its (cmid, dtype).  Last, ``K9_REFUSED`` (cmid 4096) must raise on the
    card in both dtypes."""
    tool = block_experiment
    block_kernel = tool.block_kernel

    def counted(fn):
        block_kernel.launches = 0
        block_kernel.general_launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {"sm90": block_kernel.launches,
                     "general": block_kernel.general_launches}

    run, launches = counted(lambda: tool.experiment(batch, repeats=repeats))
    want = {"sm90": 2 + repeats * 10, "general": 0}
    run_f32, launches_f32 = counted(lambda: tool.experiment(
        batch, repeats=f32_repeats, dtype=torch.float32))
    want_f32 = {"sm90": 0, "general": 2 + f32_repeats * 10}
    if launches != want or launches_f32 != want_f32:
        raise SystemExit("block_experiment: launches %s and %s; want %s and "
                         "%s" % (launches, launches_f32, want, want_f32))

    def compare(y, ref, y2=None, **fields):
        tol = TOL_BLOCK_F32 if y.dtype == torch.float32 else TOL_BLOCK
        y = y.float()
        ref_max = ref.abs().max().item()
        err = (y - ref).abs().max().item()
        out = dict(fields, max_abs_err=err, y_ref_max=ref_max,
                   rel_err=err / ref_max, tol=tol,
                   rel_norm=((y - ref).norm() / ref.norm()).item())
        out["ok"] = err <= tol * ref_max
        if y2 is not None:
            out["bit_identical"] = torch.equal(y, y2.float())
            out["ok"] = out["ok"] and out["bit_identical"]
        return out

    def routed(args, want_route, **fields):
        """Two launches against block_plain, through ``want_route``."""
        (y, y2), n = counted(lambda: (block_kernel(*args),
                                      block_kernel(*args)))
        ref = tool.block_plain(*args).float()
        case = compare(y, ref, y2, route=want_route, **fields)
        case["launches"] = n
        case["ok"] = case["ok"] and n[want_route] == 2
        if y.dtype == torch.float32:
            control = with_tf32(lambda: tool.block_plain(*args)).float()
            case["control_tf32_rel_err"] = \
                (control - ref).abs().max().item() / case["y_ref_max"]
            case["ok"] = case["ok"] and \
                case["control_tf32_rel_err"] > TOL_BLOCK_F32
        return case

    sets = []
    for dt in (torch.bfloat16, torch.float32):
        for i, (cin, cmid, cout) in enumerate(tool.STAGE1_SETS):
            args = tool.inputs(batch, cin, cmid, cout, seed=1 + i, dtype=dt)
            case = routed(args, "sm90" if dt == torch.bfloat16
                          else "general", batch=batch,
                          channels=[cin, cmid, cout],
                          dtype=str(dt).replace("torch.", ""))

            def call():
                return block_kernel(*args)

            case.update(plan=tool.plan(batch, cin, cmid, cout, dtype=dt),
                        kernel_ms=cuda_ms(call, 20), **tool.times(call),
                        plain_ms=cuda_ms(lambda: tool.block_plain(*args), 3),
                        library_ms=cuda_ms(
                            lambda: tool.library_block(*args), 20),
                        **block_bound(batch, cin, cmid, cout, dt))
            sets.append(case)
            del args

    args = tool.inputs(2, 16, 16, 32, seed=2)
    ref = tool.block_plain(*args).float()
    ys = [block_kernel(*args, rows=r) for r in tool.ROWS]
    rows_case = compare(ys[0], ref, channels=[16, 16, 32], rows=tool.ROWS)
    rows_case["bit_identical"] = all(torch.equal(ys[0], y) for y in ys)
    rows_case["ok"] = rows_case["ok"] and rows_case["bit_identical"]
    del ys
    bands = []
    for cin, cmid, cout in [(16, 16, 32)] + list(tool.STAGE1_SETS):
        args = tool.inputs(2, cin, cmid, cout, seed=3)
        ref = tool.block_plain(*args).float()
        for band in tool.BANDS:
            bands.append(compare(
                tool._launch(*args, band=band), ref,
                tool._launch(*args, band=band), channels=[cin, cmid, cout],
                band=band))
    ranges = []
    for cin, cmid, cout in K9_RANGE_SETS:
        args = tool.inputs(2, cin, cmid, cout, seed=4)
        ranges.append(routed(args, "sm90", channels=[cin, cmid, cout],
                             plan=tool.plan(2, cin, cmid, cout)))
    general = []
    for dt, channel_sets in (
            (torch.bfloat16, K9_GENERAL_SETS),
            (torch.float32, K9_GENERAL_SETS + K9_RANGE_SETS
             + [(16, 16, 32)] + K9_GENERAL_F32_EXTRA)):
        for cin, cmid, cout in channel_sets:
            args = tool.inputs(2, cin, cmid, cout, seed=5, dtype=dt)
            general.append(routed(
                args, "general", channels=[cin, cmid, cout],
                dtype=str(dt).replace("torch.", ""),
                plan=tool.plan(2, cin, cmid, cout, dtype=dt)))
    for (cin, cmid, cout), dt in K9_WIDE_SETS:
        args = tool.inputs(1, cin, cmid, cout, seed=6, dtype=dt)
        case = routed(args, "general", channels=[cin, cmid, cout],
                      dtype=str(dt).replace("torch.", ""), batch=1,
                      plan=tool.plan(1, cin, cmid, cout, dtype=dt),
                      kernel_ms=cuda_ms(lambda: block_kernel(*args), 3))
        general.append(case)
        del args
    tiles = []
    for (cmid, dt), want in K9_TILES.items():
        got = tool.plan(1, cmid, cmid, 256, dtype=dt)
        tiles.append({"cmid": cmid, "dtype": str(dt).replace("torch.", ""),
                      "tile": got["tile"], "want": want, "smem": got["smem"],
                      "ok": got["route"] == "general"
                      and got["tile"] == want})
    refused = {}
    cin, cmid, cout = K9_REFUSED
    for dt in (torch.bfloat16, torch.float32):
        key = str((K9_REFUSED, str(dt).replace("torch.", "")))
        # the weights as views of one zero: the router reads shapes only
        zero = torch.zeros(1, 1, 1, dtype=dt, device="cuda")
        scales = torch.ones(3, max(cin, cmid), device="cuda")
        try:
            block_kernel(torch.zeros(1, 56, 56, cin, dtype=dt, device="cuda"),
                         zero[0].expand(cin, cmid), zero.expand(9, cmid, cmid),
                         zero[0].expand(cmid, cout), scales, scales)
            refused[key] = False
        except mx.base.MXNetError:
            refused[key] = True
    torch.cuda.synchronize()
    out = {"tool_run": run, "launches": launches,
           "tool_run_f32": run_f32, "launches_f32": launches_f32,
           "tol": TOL_BLOCK, "tol_f32": TOL_BLOCK_F32, "sets": sets,
           "rows": rows_case, "bands": bands, "range_sets": ranges,
           "general_sets": general, "tiles": tiles, "refused": refused}
    emit("block_experiment", **out)
    bad = [e for e in sets + [rows_case] + bands + ranges + general + tiles
           if not e["ok"]]
    if bad:
        raise SystemExit("block_experiment: K9 disagrees with block_plain, "
                         "differs between launches, took another route or "
                         "tile, or its TF32 control passed: %s"
                         % json.dumps(bad))
    if not all(refused.values()):
        raise SystemExit("block_experiment: K9 took a shape past the "
                         "general kernel's limits: %s" % json.dumps(refused))
    return out


#: what the summary line keeps of each K5, K7 and K8 case
K5_SHAPE_KEYS = ("shape", "device_ms", "kernel_ms", "host_us", "dot_ms",
                 "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "bound_split_tf32_ms", "bound_cuda_core_ms", "max_abs_err",
                 "s1_rel_norm", "s2_rel_norm", "bit_identical")


def experiment_summary(name, source, replaces, entries, launches, **extra):
    """A K7 or K8 entry of the kernel summary line: the times summed over
    the tool's 8 shapes, one call each; ``ms`` is the card's time
    (``device_ms``), ``wall_ms`` the same calls timed with the wrapper's
    host time; ``shapes`` keeps every case."""
    def total(key):
        return sum(e[key] for e in entries)

    t_ops = total("flops") / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    return dict({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(e["max_abs_err"] for e in entries),
        "ms": total("device_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("library_ms"), "wall_ms": total("kernel_ms"),
        "dot_ms": total("dot_ms"),
        "per": "the 8 shapes of the tool at batch 128, one call each, bf16",
        "shapes": [{k: e[k] for k in K5_SHAPE_KEYS if k in e}
                   for e in entries]}, **extra)


def k5_summary(entries, launches, ptxas, **extra):
    """K5's entry of the kernel summary line: the bf16 cases summed over
    one training step's 16 launches (each shape times its launches per
    step), so ``ms`` (the card's time, ``device_ms``), ``wall_ms`` (with
    the wrapper's host time), ``dot_ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` are per step; ``shapes`` keeps every case."""
    step = [e for e in entries if e["launches_per_step"]]

    def total(key):
        return sum(e[key] * e["launches_per_step"] for e in step)

    t_ops = sum(e["flops"] * e["launches_per_step"] for e in step) \
        / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = sum(e["bytes"] * e["launches_per_step"] for e in step) \
        / HBM_BYTES_PER_S * 1e3
    return dict({
        "name": "matmul_stats", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/matmul_stats.cu",
        "replaces": "mxnet_tpu/ops/fused.py:169", "launches": launches,
        "max_abs_err": max(e["max_abs_err"] for e in entries),
        "ms": total("device_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("library_ms"), "wall_ms": total("kernel_ms"),
        "dot_ms": total("dot_ms"), "per": "one training step, "
        "%d launches, bf16" % K5_PER_STEP, "ptxas": ptxas,
        "shapes": [{k: e[k] for k in ("dtype", "launches_per_step",
                                      "padded") + K5_SHAPE_KEYS if k in e}
                   for e in entries]}, **extra)


def k5_f32_summary(entries, launches):
    """The f32 K5's entry of the kernel summary line (split TF32, its own
    kernel in ``matmul_stats.cu``): the two f32 shapes of the kernels phase
    summed, one call each; ``launches`` from ``resnet_train_check``'s f32
    step."""
    f32 = [e for e in entries if e["dtype"] == "float32"
           and e["shape"] in map(list, K5_F32_SHAPES)]

    def total(key):
        return sum(e[key] for e in f32)

    t_ops = 3.0 * total("flops") / TF32_FLOPS * 1e3
    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    return {
        "name": "matmul_stats_f32", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/matmul_stats.cu",
        "kernel": "matmul_stats_tf32_kernel",
        "replaces": "mxnet_tpu/ops/fused.py:169", "launches": launches,
        "launches_from": "resnet_train_check: one f32 step",
        "max_abs_err": max(e["max_abs_err"] for e in f32),
        "ms": total("device_ms"), "plain_ms": total("plain_ms"),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": total("library_ms"), "wall_ms": total("kernel_ms"),
        "dot_ms": total("dot_ms"),
        "per": "the two f32 shapes %s, one call each" % K5_F32_SHAPES,
        "shapes": [{k: e[k] for k in K5_SHAPE_KEYS if k in e} for e in f32]}


def block_summary(name, source, launches, sets, ptxas, **extra):
    """A K9 entry of the kernel summary line from the block phase's batch
    128 cases of one route: the first stage-1 set's numbers, ``sets``
    keeping both."""
    first = sets[0]
    return dict({
        "name": name, "route": "cuda", "source": source,
        "replaces": "tools/pallas_block_experiment.py:107",
        "launches": launches, "max_abs_err": first["max_abs_err"],
        "ms": first["device_ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": first["library_ms"],
        "per": "one stage-1 block, batch 128, %s, %s; ms is the card's "
        "time, wall_ms with the wrapper's host time"
        % (tuple(first["channels"]), first["dtype"]),
        "wall_ms": first["kernel_ms"], "host_us": first["host_us"],
        "sets": [{k: e[k] for k in (
            "channels", "dtype", "device_ms", "kernel_ms", "host_us",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
            "rel_err", "plan", "bit_identical") + (
                ("control_tf32_rel_err",) if "control_tf32_rel_err" in e
                else ())} for e in sets],
        "ptxas": ptxas}, **extra)


def kernel_summary(name, source, replaces, also_replaces, case, launches,
                   **extra):
    """One entry of the kernel summary line, from a kernels-phase case and
    the launches of the main path's run."""
    return dict({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "also_replaces": also_replaces,
        "launches": launches, "max_abs_err": case["max_abs_err"],
        "ms": case["kernel_ms"], "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
        "library_ms": case["library_ms"], "shape": case["shape"],
        "dtype": case["dtype"], "causal": case["causal"]}, **extra)


def _case(entries, shape, dtype):
    return next(e for e in entries if e["shape"] == shape
                and e["dtype"] == dtype and e["causal"])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    env_phase()
    ptxas = build_phase()
    fwd = kernels_phase()
    for e in fwd:
        e["max_abs_err"] = max(e["err_o"], e["err_lse"])
    bwd = kernels_bwd_phase()
    delta = delta_phase(bwd)
    op_routes_phase()
    serve = serve_phase(mx.gpu(0), FULL)
    emit("serve", **serve)
    train = train_phase(mx.gpu(0), FULL)
    emit("train", **train)
    train_check = train_check_phase(mx.gpu(0), FULL)
    emit("train_check", **train_check)
    module = module_train_phase(mx.gpu(0), FULL)
    emit("module_train", **module)
    module_check = module_check_phase(mx.gpu(0), FULL)
    emit("module_check", **module_check)
    emit("bucketing_train", **bucketing_train_phase(mx.gpu(0)))
    emit("bucketing_check", **bucketing_check_phase(mx.gpu(0)))
    emit("rnn_ops", **rnn_ops_phase(mx.gpu(0)))
    emit("module_api", **module_api_phase(mx.gpu(0)))
    k5 = resnet_kernels_phase()
    resnet = resnet_train_phase(mx.gpu(0))
    emit("resnet_train", **resnet)
    resnet_check = resnet_train_check_phase(mx.gpu(0))
    emit("resnet_train_check", **resnet_check)
    with tempfile.TemporaryDirectory() as workdir:
        recs, records_s = make_image_records(workdir)
        emit("image_io", records_s=records_s, **image_io_phase(recs))
        imagenet = imagenet_train_phase(mx.gpu(0), recs)
        emit("imagenet_train", staged_images_per_s=resnet["images_per_s"],
             **imagenet)
        emit("imagenet_module", **imagenet_module_phase(mx.gpu(0), recs))
    rtc = rtc_phase()
    mse = matmul_stats_experiment_phase()
    blk = block_experiment_phase()
    train_shape = list(TRAIN_SHAPE[:4])
    fwd_train = _case(fwd, train_shape, "bfloat16")
    bwd_train = _case(bwd, train_shape, "bfloat16")
    fwd_src = FLASH_SOURCES["flash_attention_fwd"]
    bwd_src = FLASH_SOURCES["flash_attention_bwd"]
    k1, k2 = ("mxnet_tpu/ops/pallas_kernels.py:283",
              "mxnet_tpu/ops/pallas_kernels.py:305")
    k3, k4 = ("mxnet_tpu/ops/pallas_kernels.py:486",
              "mxnet_tpu/ops/pallas_kernels.py:499")

    def shape_fields(case):
        return {k: case[k] for k in (
            "shape", "dtype", "source", "max_abs_err", "kernel_ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by")
            + (("bound_cuda_core_ms",) if "bound_cuda_core_ms" in case
               else ())}

    def f32_fields(entries, name):
        """The f32 kernel's rows beside the serving shape's: T=4096 and
        the other head dims, with -Xptxas -v's report of each D."""
        return {
            "t4096": shape_fields(_case(entries, [1, 4096, 16, 64],
                                        "float32")),
            "d32": shape_fields(_case(entries, [4, 1024, 8, 32], "float32")),
            "d128": shape_fields(_case(entries, [4, 1024, 8, 128],
                                       "float32")),
            "ptxas": ptxas[name]}

    module_shape = list(MODULE_SHAPE[:4])

    def module_launches(name):
        """The Module route's launches of one flash kernel (module_train:
        f32, full width)."""
        per_score = module["score_launches"][name] / module["batches"]
        return {"fit": module["fit_launches"][name],
                "per_forward_backward":
                    module["launches_per_forward_backward"][name],
                "per_score_batch": per_score,
                "module_check": module_check["launches"][str(mx.gpu(0))][
                    name]}

    rtc_full, rtc_vec = (next(e for e in rtc["flows"] if e["name"] == n)
                         for n in ("rtc_abs_full", "rtc_abs_vec_full"))
    delta_train = next(e for e in delta if e["shape"] == list(
        TRAIN_SHAPE[:4]) and e["dtype"] == "bfloat16")
    delta_f32, delta_module = (
        next(e for e in delta if e["shape"] == shape
             and e["dtype"] == "float32")
        for shape in ([4, 1024, 16, 64], module_shape))
    print(json.dumps({"kernels": [
        # f32, the split-TF32 kernels: serving (K1) and the f32 train check
        kernel_summary(
            "flash_attention_fwd", fwd_src["float32"], k1, k2,
            _case(fwd, [4, 1024, 16, 64], "float32"), serve["launches"],
            sources=fwd_src, train_shape=shape_fields(fwd_train),
            bound_cuda_core_ms=_case(fwd, [4, 1024, 16, 64],
                                     "float32")["bound_cuda_core_ms"],
            module_launches=module_launches("flash_attention_fwd"),
            module_shape=shape_fields(_case(fwd, module_shape, "float32")),
            **f32_fields(fwd, "flash_attention_fwd")),
        kernel_summary(
            "flash_attention_bwd", bwd_src["float32"], k3, k4,
            _case(bwd, [4, 1024, 16, 64], "float32"),
            train_check["launches"][str(mx.gpu(0))]["flash_attention_bwd"],
            sources=bwd_src,
            launches_from="train_check: one f32 step of 2 layers",
            bound_cuda_core_ms=_case(bwd, [4, 1024, 16, 64],
                                     "float32")["bound_cuda_core_ms"],
            module_launches=module_launches("flash_attention_bwd"),
            module_shape=shape_fields(_case(bwd, module_shape, "float32")),
            **f32_fields(bwd, "flash_attention_bwd")),
        # delta = rowsum(dO * O) for both backward routes
        {"name": "flash_attention_delta", "route": "cuda",
         "source": "mxnet_tpu_torch/csrc/flash_attention_delta.cu",
         "replaces": "mxnet_tpu/ops/pallas_kernels.py:468",
         "replaces_what": "the jnp delta beside K3/K4's pallas_call",
         "launches": train["delta_launches"],
         "max_abs_err": delta_train["max_abs_err"],
         "ms": delta_train["kernel_ms"], "plain_ms": delta_train["plain_ms"],
         "bound_ms": delta_train["bound_ms"],
         "bound_by": delta_train["bound_by"],
         "library_ms": delta_train["library_ms"],
         "shape": delta_train["shape"], "dtype": "bfloat16",
         "f32_serving_shape": {k: delta_f32[k] for k in (
             "max_abs_err", "kernel_ms", "plain_ms", "library_ms",
             "bound_ms")},
         "module_launches": module_launches("flash_attention_delta"),
         "module_shape": {k: delta_module[k] for k in (
             "shape", "max_abs_err", "kernel_ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by")},
         "ptxas": ptxas["flash_attention_delta"]},
        # bf16, the tensor-core kernels: GPT training (K1, K3)
        kernel_summary(
            "flash_attention_fwd_sm90", fwd_src["bfloat16"], k1, k2,
            fwd_train, train["launches"]["flash_attention_fwd"],
            sources=fwd_src, train_shape=shape_fields(fwd_train),
            t4096=shape_fields(_case(fwd, [1, 4096, 16, 64], "bfloat16")),
            ptxas=ptxas["flash_attention_fwd_sm90"]),
        kernel_summary(
            "flash_attention_bwd_sm90", bwd_src["bfloat16"], k3, k4,
            bwd_train, train["launches"]["flash_attention_bwd"],
            sources=bwd_src, train_shape=shape_fields(bwd_train),
            t4096=shape_fields(_case(bwd, [1, 4096, 16, 64], "bfloat16")),
            ptxas=ptxas["flash_attention_bwd_sm90"]),
        k5_summary(k5, resnet["launches"]["matmul_stats"],
                   ptxas["matmul_stats"],
                   imagenet_launches=imagenet["launches"]["matmul_stats"],
                   imagenet_steps=imagenet["steps"]),
        k5_f32_summary(k5, resnet_check["k5_launches"]),
        {"name": "rtc", "route": "cuda", "source": "mxnet_tpu_torch/rtc.py",
         "generated": "build/kernels/rtc_rtc_abs_full-<hash>.cu",
         "replaces": "mxnet_tpu/rtc.py:105", "launches": rtc["launches"],
         "max_abs_err": max(e["max_abs_err"] for e in rtc["flows"]),
         "ms": rtc_full["kernel_ms"], "plain_ms": rtc_full["plain_ms"],
         "bound_ms": rtc_full["bound_ms"], "bound_by": "bytes",
         "library_ms": rtc_full["library_ms"],
         "per": "abs over an (8192, 8192) f32 array, one element a thread; "
         "the launches are the six pushes of the rtc_kernels phase",
         "vectorised": {k: rtc_vec[k] for k in (
             "name", "grid", "block", "kernel_ms", "plain_ms", "library_ms",
             "bound_ms", "max_abs_err")}},
        experiment_summary(
            "matmul_stats_experiment.matmul_stats",
            "mxnet_tpu_torch/csrc/matmul_stats.cu",
            "tools/pallas_matmul_stats_experiment.py:70",
            mse["matmul_stats"], mse["launches"]["matmul_stats"],
            entry="mxtt_matmul_stats with c = 0"),
        experiment_summary(
            "matmul_stats_experiment.matmul_stats_prologue",
            "mxnet_tpu_torch/csrc/matmul_stats.cu",
            "tools/pallas_matmul_stats_experiment.py:103",
            mse["matmul_stats_prologue"],
            mse["launches"]["matmul_stats_prologue"],
            entry="mxtt_matmul_stats_prologue"),
        block_summary(
            "bottleneck_block", "mxnet_tpu_torch/csrc/bottleneck_block.cu",
            blk["launches"]["sm90"],
            [e for e in blk["sets"] if e["dtype"] == "bfloat16"],
            ptxas["bottleneck_block"]),
        block_summary(
            "bottleneck_block_general",
            "mxnet_tpu_torch/csrc/bottleneck_block_general.cu",
            blk["launches_f32"]["general"],
            [e for e in blk["sets"] if e["dtype"] == "float32"],
            ptxas["bottleneck_block_general"],
            launches_from="the tool's run in f32 at batch 128",
            general_sets=[{k: e[k] for k in (
                "channels", "dtype", "rel_err", "bit_identical", "plan")}
                for e in blk["general_sets"]]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
