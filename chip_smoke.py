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
   loaded by ``Predictor`` on ``gpu(0)`` and served through ``BatchLadder``
   (one CUDA graph captured a rung, 1 and 4), ``Batcher`` and ``Server``:
   six one-row requests from threads, one three-row request, one alone;
   every answer checked; ``/metrics`` counting the requests and rung
   dispatches sent, ``/healthz?deep=1`` healthy, ``/alerts``; a
   ``serve.dispatch`` fault answering 500 and a traced ``POST /predict``
   answering with its ``X-Trace-Id`` and ``traceparent``;
   ``mxtpu_compile_total`` flat over the requests; the kernel's launch
   count (one eager forward and one capture a rung) and 12 flash kernels
   in the device trace of one replay; each rung's replay against an eager
   forward of the same rung (within 1e-6 of max |d log p|, bit equality
   reported) with both dispatch walls and both ladders' memory; one
   request recomputed on the CPU;
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
   ``save_checkpoint`` (its CRC manifest verified) and ``Module.load`` on
   ``gpu(0)``, whose score must equal the first within 1e-6; ms per batch, peak memory, and f32
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
13. ``op_corpus``: every op of ``tools/op_corpus.py``'s corpus (the dense
   ops: element-wise, broadcast, reductions, indexing, ordering, the nn
   ops, the update ops; 1-d and 3-d Convolution and Pooling) on the card
   and on the CPU from the same seeded inputs in f32, TF32 off: outputs
   and the gradient of ``sum(out * cot)`` within ``TOL_OP_CORPUS``, the
   indices, 0/1 results and sorted values to the bit with ties planted;
   each sampler's bits equal from one seed twice, its moments within
   ``TOL_SAMPLER_Z`` standard errors; the worst five ops printed; then
   ``test_utils.check_consistency`` of a Deconvolution-BatchNorm-
   LeakyReLU-Convolution block on both devices, its worst reading within
   ``TOL_CONSISTENCY``; the TF32 controls of both must miss their bounds;
14. ``autograd_check``: the imperative loop of ``mx.autograd``
   (``mark_variables``, ``record``, FullyConnected/Activation/
   SoftmaxOutput, ``nd.sgd_update``) at ``train_mnist.py``'s MLP widths,
   batch 100, 20 steps, on the card and the CPU from the same weights
   within ``TOL_AUTOGRAD_CHECK`` (a TF32 control must miss it); then
   ``nd._contrib_FlashAttention`` recorded in f32 at B=4, T=1024, H=16,
   D=64 causal and differentiated: the f32 K1 and K3 launch once each and
   their bf16 (sm90) sources never, counted by source, and dQ, dK and dV
   equal the Executor route's bits;
15. ``dcgan_train``: ``tools/dcgan.py`` (the Module API: Deconvolution,
   LeakyReLU, LogisticRegressionOutput, ``+=`` on gradient arrays, input
   gradients into the generator's backward) at the reference MXNet
   example's widths (a 512-256-128-64-3 generator, a 64-128-256-512-1
   discriminator, 64x64x3, z 100, batch 64, Adam 2e-4) for two epochs of
   2048 made images: parameter counts, the median ms of an iteration past
   the first epoch and images/s, peak memory, the discriminator's
   accuracy, every count 0 (no kernel lies on this path);
16. ``dcgan_check``: three iterations of the same loop at size 16 on the
   card and the CPU from the same parameters, noise and images: each
   leaf's change and each moving statistic's within their bounds, and a
   control with TF32 in cuBLAS and cuDNN both must miss one;
17. ``detection_ops``: the ten ops of the detection path on the card
   against the CPU: the op corpus's cases of them (gradients included);
   MultiBoxPrior, MultiBoxTarget (hard negatives 3:1) and
   MultiBoxDetection (NMS over the 400 best) at SSD300's 8108 anchors,
   batch 32, padded labels (the masks, class targets and detected class
   ids equal, boxes within ``TOL_DETECTION``); Proposal and ROIPooling at
   the R-CNN's shapes; each MultiBox op's ms and the NMS loop's, and
   MultiBoxTarget, MultiBoxDetection and Proposal under
   ``torch.cuda.set_sync_debug_mode("error")``: no host sync;
18. ``ssd_train``: ``tools/ssd.py`` at ``examples/ssd/train.py``'s defaults
   (SSD300 over VGG16 reduced, 20 classes, batch 32, SGD 0.004) for two
   epochs of 512 made 300-px records through ``DetRecordIter`` and
   ``Module.fit``: the parameter count, every parameter finite, the
   CrossEntropy and SmoothL1 falling, the median ms of a batch, images/s,
   the share of ``DetRecordIter.next``, peak memory, every count 0;
19. ``ssd_check``: one f32 step of ``ssd_mini`` (96 px, batch 8) on the
   card and the CPU from the same parameters, within ``TOL_SSD_CHECK`` (a
   TF32 control must miss it); then ``ssd_mini`` trained on the card as
   ``tests/test_ssd_e2e.py`` trains it, to a VOC07 mAP above
   ``TOL_SSD_MAP`` through ``evaluate_net``;
20. ``rcnn_train``: ``tools/rcnn.py`` (Faster R-CNN end to end: Proposal,
   the ``proposal_target`` Custom op on the host, ROIPooling) for one
   epoch of its 200 images, then ``evaluate`` on its 50: losses, mAP, ms a
   step, the Custom op's host round trips a step, every count 0;
21. ``kernels`` of K5 (``matmul_stats``, the GEMM with the BatchNorm
   statistics epilogue) against its plain version at the 8 shapes one
   ResNet-50 training step gives it in bf16, at 2 of them in f32 and at
   the cuda tests' shapes (one of which the wrapper pads for TMA in both
   dtypes), each bit-identical across two launches; per step shape the
   card's time (a CUDA graph's replay), the wrapper's host time, cuBLAS's
   bare product and the time with the host's share; at the 2 f32 shapes
   (split TF32 on the tensor cores) the card's time, cuBLAS's f32 product
   (TF32 off) and the bound of the product as split TF32 beside the
   CUDA-core one;
22. ``resnet_train``: ResNet-50 v2 at ``tools/bench.py``'s configuration
   (batch 128, 224x224, bf16, NHWC, block fusion, SGD momentum) on
   ``gpu(0)``: ten steps after a warm-up, every loss finite, the last
   below the first, every moving statistic moved, the fusion plan 50
   blocks with 16 on K5 and K5 launched 16 times a step, none of them
   through the wrapper's padding; then ms/step,
   images/s, peak memory and a profile of one step (K5's share, and the
   count of cuDNN layout transposes);
23. ``resnet_train_check``: one f32 SGD step of ResNet-50 at batch 8,
   64x64, on ``gpu(0)`` and on the CPU; every parameter's and moving
   statistic's change agrees within a stated relative tolerance, and a
   TF32 control must not;
24. ``image_io``: the records of the ImageNet path made on the card from
    seeds (``io_train_bench.make_class_rec``: 2048 train, 512 validation
    and 128 Module-route 256-px JPEGs of 4 colour classes); the JPEG
    decoders the host offers, the port's native library built from
    ``mxnet_tpu_torch/csrc/host`` (its compiler line and time), the native
    pipeline's images/s at 1, 2, 4 and all cores' decode threads, the
    validation records at one thread against all cores as multisets, and
    the decode against PIL's on the same records;
25. ``imagenet_train``: ``tools.train_imagenet``'s fused route (ResNet-50
    v2, batch 128, 224x224, bf16, NHWC, block fusion, SGD momentum 0.9, lr
    0.1, wd 1e-4) for two epochs of the train records through the native
    pipeline, raw uint8 normalized on the card, and a
    ``DevicePrefetchIter`` of depth 2, with validation; every loss finite
    and the last below the first, every moving statistic moved, 50 blocks
    with 16 on K5 and K5 launched 16 times a step (every other kernel 0),
    the validation accuracy above ``TOL_VAL_ACCURACY`` once the moving
    statistics are re-estimated at the final weights; then
    ``io_train_bench.train_loop`` sequential and prefetched (images/s,
    per-stage walls) beside ``resnet_train``'s staged-batch images/s, and
    three steps through the queue equal to the same three staged inline,
    to the bit;
26. ``imagenet_module``: the ``--fused 0`` route (``Module.fit``, f32
    NCHW, batch 32) on the Module records under ``MXNET_FUSE_BLOCKS=1``:
    the plan's blocks, none on K5 and every count 0, ms per batch;
27. ``resume_train``: the preemption drill of ``tools.resume_train`` on
    the train records (ResNet-50, batch 128, 224x224, bf16, NHWC, block
    fusion, one decode thread, cuDNN deterministic, SGD lr 0.01 halved
    every 4 updates): run U (``RESUME_STEPS`` steps) here; run P in a
    child process with ``install_preemption_handler``, sent SIGTERM after
    step ``RESUME_SIGNAL_AFTER``, which must save that step's state at
    once and exit 0 with a manifest that verifies, its batches U's and its
    saved state U's after the same step; run R in a fresh child
    (``load_latest_checkpoint(load_optimizer_states=True)``,
    ``restore_data_iter``): its batches equal U's after the checkpoint
    (labels and the CRC32 of the uint8 pixels), every loaded array
    equal to P's (CRC32 against the manifest), its losses U's exactly,
    K5 16 launches a step in U and in R; the
    iterator restored with the data state dropped must fail the batch
    check; the checkpoint's bytes and its save and load walls; then
    ``tools.train_imagenet --fused 1 --model-prefix`` for one epoch of the
    validation records and ``--load-epoch 1`` for a second, each epoch's
    checkpoint verified; then ``telemetry_train``, whose sinks-on run
    also samples the cost database every step (no host sync in a step);
27a. ``analysis``: the analysis layer and the cost database
    (``analysis_phase``): ``verify_model`` over the zoo, the full-width
    GPT and ResNet-50 without an error; ResNet-50's bench trainer with
    ``strict=True`` giving the plain trainer's two losses to the bit, and
    a broken symbol refused with MXG005 before anything runs or is
    allocated; memlive's predicted peak against the allocator's measured
    one for the GPT's rung-4 forward and the ResNet-50 step (MXG018
    exactly when the drift passes ``MXNET_TPU_MEMLIVE_TOL``), beside the
    serve phase's eager peak and graph pool and PR 20's; the ladder
    refusing an over-tight budget before any capture; bf16 GPT (K1, K3)
    and ResNet-50 (K5) steps with the cost database sampling every step
    and no host sync, its records read back strictly with every MFU at
    most 1; a cost model fitted on them, MXG010 over ResNet-50 and the
    ladder's rungs priced beside their walls;
28. ``zoo_kernels``: K5 against its plain version at each of the 19
    distinct shapes of Inception-v3's 40 K5 blocks (batch 128, 299x299,
    bf16; ``inception_k5_shapes`` reads them from the plan), bit-identical
    across two launches and never padded, with the card's time, the
    wrapper's host time, cuBLAS's bare product, plain, library and bound
    times, and their sums over one step;
29. ``inception_train``: ``tools.train_imagenet --network inception-v3
    --image-shape 3,299,299 --fused 1 --dtype bfloat16`` (batch 128, 1000
    classes, SGD momentum 0.9, lr ``INCEPTION_LR``, wd 1e-4) for one epoch
    of 2048 made 320-px records through the native pipeline and a
    ``DevicePrefetchIter``, with validation: every loss finite and the
    last below the first, every moving statistic moved, 94 blocks with 40
    on K5 and K5 launched 40 times a step (every other kernel 0); then ms
    a staged step, images/s, peak memory and a profile of one step (the
    device's busy share); ``inception_check``: one f32 SGD step of an
    ``Inception7A`` block with a head (2312 rows, not a multiple of K5's
    tiles) on the fused route on the card (its 4 1x1 heads on the f32 K5)
    against the Executor route (``Module``) on the CPU, within
    resnet_train_check's bounds;
30. ``zoo_score``: ``tools.benchmark_score`` over the ten zoo networks on
    the Executor route (f32 NCHW) and the fused route (bf16 NHWC) at batch
    32, and ResNet-50 and Inception-v3 at batch 1 too: images/s each,
    every count 0;
31. ``zoo_serve``: the serving CLI's ``--model inception-bn`` route
    (fresh Xavier weights from its seed) behind the batch ladder (one
    CUDA graph a rung, cuDNN's convolutions in them): six
    one-image requests from threads and one of two images over HTTP, each
    answer within ``TOL_ZOO_SERVE`` of a CPU Predictor on the same weights;
32. ``ring_gpt``: one full-width GPT training step with
    ``attention="ring"`` (``_contrib_RingAttention``) and one with
    ``"flash"`` from the same weights: losses, parameters and Adam states
    equal to the bit, the bf16 K1 and K3 launched 12 times each;
33. ``contrib_ops``: the op corpus's cases of CTCLoss, quantize,
    dequantize, fft, ifft, count_sketch, SwitchMoE and RingAttention on
    the card against the CPU, forward and gradient, and each under
    ``set_sync_debug_mode("error")``: no host sync;
34. ``ctc_ocr``: ``tools.lstm_ocr`` (LSTMCell, FullyConnected, CTCLoss
    through the Module API) for 10 epochs of 384 strips at lr 0.015, batch
    32: exact-match above ``TOL_CTC_ACCURACY``, every count 0;
35. ``rtc_kernels``: ``mx.rtc`` (K6) compiles the three flows of the JAX
    package's ``tests/test_rtc.py`` written in CUDA C, abs written as a
    CUDA programmer writes it for this card (float4 in a grid-stride
    loop), and both abs bodies over an (8192, 8192) f32 array, and pushes
    each once; each output equals the callable (plain) form's exactly; the
    two full-size ones are timed against ``torch.abs`` and their byte
    bound;
36. ``matmul_stats_experiment``: the tool of that name at its 8 ResNet-50
    shapes at batch 128, then K7 (K5 with c = 0) and K8 (the prologue
    variant) against their plain versions at each shape, bit-identical
    across two launches, with the kernel (the card's, and with the host's
    share), plain, library, cuBLAS product and bound times;
37. ``block_experiment``: the tool of that name at batch 128 with its
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
    cmid 4096 must raise in both dtypes;
38. ``autotune`` (last: it leaves the tuning cache empty and the
    variables unset, so every phase before it ran the built-in tiles):
    every tile the tuners may pick against the plain versions (K1 and K3
    at the GPT's training and serving shapes, timed, and at every head
    dim; K5's configs at the 8 ResNet-50 shapes in bf16 and 2 in f32,
    timed); ``tools.autotune --model resnet50 --batch 128`` twice, each
    in a process of its own (the second: every key cached, none tuned),
    the GPT's flash keys twice; ``tools.plan_search`` of ResNet-50 twice
    (the second cached; the committed plan no slower than greedy); from
    the committed cache the bench trainer (every tune and plan lookup a
    hit, K5 on each of the plan's K5 blocks, losses within
    ``TOL_TUNED_LOSS`` of a run with both off), the bf16 GPT step and
    the f32 ladder (flash hits, replays equal to the eager forward to the
    bit); a flash forward captured in ``search`` mode (no search inside
    the capture, one after it); the K5 and K1 wrappers' host us a call
    with the cache off, empty and hit;
39. ``dist_train``: data parallelism, two ranks on the one card (gloo:
    NCCL refuses two ranks on one device) through
    ``mxnet_tpu_torch/tools/launch.py`` and ``tools.dist_train``: the
    full-width GPT (bf16, global batch 16, 8 a rank, 4 steps) on the
    train phase's weights and batch, its losses within ``TOL_DIST_LOSS``
    of that phase's; ResNet-50 (global batch 128, 3 steps, the rank
    halves of the batch differing in distribution) against one process
    here: losses within ``TOL_DIST_LOSS``, the moving statistics after a
    step within ``TOL_DIST_AUX`` of one process's in units of its step,
    and a control (each rank's BatchNorm over its own rows) beyond it;
    the masters' gap recorded beside the floor rounding sets (one process
    on the batch with its halves swapped);
    the ranks' masters and aux states CRC32-equal, K1, K3 and delta 12 a
    step and K5 16 a step on each rank; the Module of ``module_train`` at
    2 layers under ``dist_sync`` with ``MXNET_TPU_OVERLAP`` off and on
    (equal to the bit) and under ``dist_async`` with DCASGD (the server's
    weights equal to a host replay of the pushes in the order it applied
    them); the recovery drill (``--restart-budget 1``, rank 1 SIGKILLed
    after the step-2 checkpoint, the resumed steps equal to the
    uninterrupted run's to the bit); the NCCL route at world 1 (a
    ``dist_sync`` push and pull of the GPT's parameters equal to the
    bit); each rank's peak memory, build, step walls and collective wait.
    ``python chip_smoke.py --dist-witness float32`` runs the ResNet-50
    comparison alone in another dtype.
Then the kernel summary line (each entry with its ``tiles``: the
built-in tile, the legal set, the tuners' winner and both times) (each kernel with its launches on its main
path, and on the DCGAN path, in autograd_check's recorded attention, on
the detection path (ssd_train and rcnn_train), on Inception-v3's path, in
ring_gpt, on the resume path (resume_train's runs U and R and its CLI
round trip) and on the zoo's other paths (zoo_score, zoo_serve, contrib_ops,
ctc_ocr) beside them, the flash kernels' by source; K5's entry with its
Inception-v3 step; the f32 flash forward's with its launches in one
profiled serving replay) and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, and the script exits non-zero without the last
line.  With no CUDA device it exits 1 at once.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import logging
import os
import random
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings

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
from mxnet_tpu_torch.ops.registry import (                      # noqa: E402
    OpContext, apply_op, get_op)
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
    block_experiment, kernel_counts, nvidia_smi, zero_kernel_counts)
from mxnet_tpu_torch.tools import matmul_stats_experiment      # noqa: E402
from mxnet_tpu_torch.tools import module_fit                   # noqa: E402
from mxnet_tpu_torch.tools import lstm_bucketing               # noqa: E402
from mxnet_tpu_torch.tools import dcgan, op_corpus             # noqa: E402
from mxnet_tpu_torch.tools import rcnn, ssd                    # noqa: E402
from mxnet_tpu_torch import test_utils                         # noqa: E402
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


#: the script's start, for each phase line's ``script_s``
T_START = time.perf_counter()


def emit(phase, **fields):
    """One phase's line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "script_s": time.perf_counter() - T_START}),
          flush=True)


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
    instantiation, named by its integer template arguments in order (the
    head dim, then the tile: ``flash_fwd_tf32<64,2,64>``,
    ``flash_bwd_dq_sm90<64,32>``, ``flash_delta_kernel<64,bf16>`` and the
    like): registers, static shared memory, stack frame and spill bytes."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            mangled = m.group(1)
            # the kernel's own name follows its length's last digit (an
            # anonymous namespace's name may hold "flash_" too)
            k = re.findall(r"(?<=\d)flash_[a-z0-9_]+?(?=I)", mangled)
            d = re.findall(r"Li(\d+)E", mangled)
            name = None
            if k and d:
                name = "%s<%s%s>" % (k[-1], ",".join(d),
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


@contextlib.contextmanager
def tf32_mode(on=True):
    """TF32 in cuBLAS and cuDNN both (a conv-only graph reads only cuDNN's
    switch; the flash kernels read neither) while the block runs, both off
    after, as :func:`env_phase` sets them."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


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
            with tf32_mode():
                co, cl = flash_attention_plain(q, k, v, causal)
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
            with tf32_mode():
                ctrl = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
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


#: the serving latency SLO of the full-width GPT (``serve_p99_latency_burn``
#: threshold): a rung-4 dispatch holds ~170 ms and a request can queue
#: behind two more, so the default 250 ms target would call one burst of
#: nine requests a burning budget
SERVE_LATENCY_SLO_S = 2.5
#: eager forward against replay: max |d log p| of each rung
TOL_REPLAY = 1e-6
#: each rung's eager and replayed dispatch walls: rounds of
#: (replay, eager, eager, replay)
SERVE_WALL_ROUNDS = 3


def _prom(text):
    """{``name{labels}``: value} of a Prometheus exposition (exemplar
    suffixes and comment lines dropped)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        if "{" in key and not key.endswith("}"):       # a space in labels
            head, _, rest = line.partition("} ")
            key = head + "}"
        out[key] = float(rest.split(" ")[0])
    return out


def _prom_delta(before, after, prefix):
    """{key: after - before} of the samples starting with ``prefix`` that
    moved."""
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if k.startswith(prefix) and v != before.get(k, 0.0)}


def _http(url, doc=None, headers=None, timeout=600):
    """(status, headers, body) of a GET, or of a POST of the JSON ``doc``;
    an HTTP error status is returned, not raised."""
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(
        url, data=data, headers=dict({"Content-Type": "application/json"},
                                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _eager_dispatch(pred, feed):
    """The eager counterpart of a ladder dispatch on a Predictor handle at
    the rung's batch: stage, forward, copy the output to the host."""
    pred.forward(data=feed)
    return pred.get_output(0)


def serve_phase(ctx, cfg, rungs=(1, 4), check_ctx=None):
    """Write a GPT checkpoint, serve it on ``ctx`` through Predictor ->
    BatchLadder (one CUDA graph a rung on the card) -> Batcher -> Server,
    check every answer and the front door's telemetry, hold each rung's
    replay against an eager forward of the same rung, and recompute one
    request on ``check_ctx`` (default: the CPU).  Returns the phase's
    fields; raises on any failed check."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import slo, tracing
    check_ctx = check_ctx or mx.cpu()
    vocab, seq, layers = cfg["vocab"], cfg["seq"], cfg["layers"]
    net = gpt_symbol(vocab, seq, cfg["d_model"], cfg["heads"], layers,
                     dropout=0.0)
    params = gpt_params(net, seq)
    tokens = np.random.RandomState(1).randint(
        0, vocab, (9, seq)).astype(np.float32)
    on_card = ctx.device_type == "gpu"
    compiles = telemetry.counter("mxtpu_compile_total")
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "gpt")
        net.save(prefix + "-symbol.json")
        mx.nd.save(prefix + "-0000.params",
                   {"arg:" + k: mx.nd.array(v, ctx=mx.cpu())
                    for k, v in params.items()})
        del params
        t0 = time.perf_counter()
        pred = mx.Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                            {"data": (1, seq)}, ctx=ctx)
        # the eager ladder: one handle a rung, run once; its footprint
        # beside the graph ladder's, and later the eager side of each
        # rung's replay check
        mem = {}
        if on_card:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        eager = {r: pred.reshaped({"data": (r, seq)}) for r in rungs}
        for r in rungs:
            _eager_dispatch(eager[r], np.zeros((r, seq), np.float32))
        if on_card:
            mem["eager_peak_bytes"] = torch.cuda.max_memory_allocated() \
                - base
            mem["eager_resident_bytes"] = torch.cuda.memory_allocated() \
                - base
            # a host sync in the forward would abort the capture
            syncs = _sync_free(
                lambda: eager[rungs[-1]]._executor.forward(is_train=False))
            if syncs is not None:
                raise SystemExit("the eager forward syncs with the host: %s"
                                 % syncs)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        flash_attention_fwd.launches = 0
        compiles_before = compiles.get()
        t_ladder = time.perf_counter()
        ladder = BatchLadder(pred, rungs=rungs)
        ladder_s = time.perf_counter() - t_ladder
        warm_launches = flash_attention_fwd.launches
        capture_compiles = compiles.get() - compiles_before
        if on_card:
            mem["graph_peak_bytes"] = torch.cuda.max_memory_allocated() \
                - base
            mem["graph_resident_bytes"] = torch.cuda.memory_allocated() \
                - base
            # what the graphs hold for good: their private pool's segments
            mem["graph_pool_bytes"] = sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) ==
                tuple(ladder._pool))
        warm_ms = dict(ladder.describe()["wall_ms"])
        batcher = Batcher(ladder, window_ms=50, queue_depth=64,
                          default_deadline_ms=600000)
        # a fresh replica's judge: the verdict covers this phase's traffic,
        # not what the process served or trained before it
        slo.reset()
        server = Server(ladder, batcher=batcher, port=0,
                        host="127.0.0.1").start()
        slo.engine().configure("serve_p99_latency_burn",
                               threshold_s=SERVE_LATENCY_SLO_S)
        base_url = "http://127.0.0.1:%d" % server.port
        results, errors = {}, []

        def go(i, rows):
            try:
                results[i] = batcher.submit({"data": tokens[i:i + rows]})[0]
            except Exception as e:  # collected and raised below
                errors.append(repr(e))

        got = {}

        def window():
            """The requests: 7 coalesced and 1 alone, the verdict, one
            faulted and one traced POST /predict, between /metrics reads."""
            got["m0"] = _prom(_http(base_url + "/metrics")[2].decode())
            threads = [threading.Thread(target=go, args=(i, 1))
                       for i in range(6)]
            threads.append(threading.Thread(target=go, args=(6, 3)))
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            got["alone"] = batcher.submit({"data": tokens[0:1]})[0]
            got["m1"] = _prom(_http(base_url + "/metrics")[2].decode())
            got["counts"] = batcher.dispatch_counts()
            slo.engine().tick()
            got["deep"] = _http(base_url + "/healthz?deep=1")
            got["alerts"] = json.loads(_http(base_url + "/alerts")[2])
            # one dispatch failed by the fault seam, then a traced request
            got["tid"] = tid = tracing.new_trace_id()
            os.environ["MXNET_TPU_FAULTS"] = "serve.dispatch:n=1"
            try:
                got["fault"] = _http(base_url + "/predict",
                                     {"data": tokens[8:9].tolist()},
                                     {"traceparent": "00-%s-%s-01" % (
                                         tid, tracing.new_span_id())})
            finally:
                os.environ["MXNET_TPU_FAULTS"] = ""
            got["tid2"] = tid2 = tracing.new_trace_id()
            got["answer"] = _http(base_url + "/predict",
                                  {"data": tokens[0:1].tolist()},
                                  {"traceparent": "00-%s-%s-01" % (
                                      tid2, tracing.new_span_id())})
            got["m2"] = _prom(_http(base_url + "/metrics")[2].decode())
            got["window_counts"] = batcher.dispatch_counts()

        try:
            compiles_served = compiles.get()
            # the launches of the requests themselves: replays run K1 from
            # the graph, past its wrapper, so the device trace counts them
            flash_attention_fwd.launches = 0
            profile = profile_device(window) if on_card else window()
            window_wrapper_launches = flash_attention_fwd.launches
            compiles_after = compiles.get()
            health = json.loads(_http(base_url + "/healthz")[2])
        finally:
            server.close()
            slo.stop_ticker()
        serve_s = time.perf_counter() - t0
        m0, m1, m2, counts = got["m0"], got["m1"], got["m2"], got["counts"]
        alone, deep, alerts = got["alone"], got["deep"], got["alerts"]
        fault, answer, tid, tid2 = (got["fault"], got["answer"], got["tid"],
                                    got["tid2"])
        if errors or len(results) != 7:
            raise SystemExit("requests failed or were shed: %s" % errors)
        if health.get("status") != "ok":
            raise SystemExit("/healthz: %r" % health)
        # the ladder dispatches of the window (the faulted one never
        # reached the ladder), each one replay of 12 K1 launches
        replays = sum(got["window_counts"].values())
        launches = profile["flash_kernels_count"] if on_card \
            else window_wrapper_launches
        if window_wrapper_launches != 0 or launches != (
                layers * replays if on_card else 0):
            raise SystemExit(
                "the requests' %d dispatches ran %d flash kernels by the "
                "device trace and %d through the wrapper; want %d and 0"
                % (replays, launches, window_wrapper_launches,
                   layers * replays if on_card else 0))
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
        # the front door: metrics, verdict, alerts, fault, trace headers
        served = _prom_delta(m0, m1, "mxtpu_serve_")
        want = {'mxtpu_serve_requests_total{outcome="ok"}': 8.0}
        want.update({'mxtpu_serve_rung_dispatch_total{rung="%d"}' % r:
                     float(n) for r, n in counts.items()})
        counted = {k: v for k, v in served.items()
                   if k.startswith(("mxtpu_serve_requests_total",
                                    "mxtpu_serve_rung_dispatch_total"))}
        if counted != want:
            raise SystemExit("/metrics counted %s for the requests sent; "
                             "want %s" % (counted, want))
        verdict = json.loads(deep[2])
        if deep[0] != 200 or verdict["health"]["status"] != "healthy" \
                or verdict["health"]["schema"] != "mxtpu-health/1":
            raise SystemExit("/healthz?deep=1: %d %s" % (deep[0], verdict))
        if alerts.get("schema") != "mxtpu-health/1" or \
                {a["rule"] for a in alerts["alerts"]} != {
                    r["name"] for r in slo.engine().rules}:
            raise SystemExit("/alerts: %s" % alerts)
        after = _prom_delta(m1, m2, "mxtpu_serve_requests_total")
        fault_doc = tracing.get_trace(tid)
        http = {
            "fault_status": fault[0],
            "fault_trace_id": fault[1].get("X-Trace-Id"),
            "answer_status": answer[0],
            "answer_trace_id": answer[1].get("X-Trace-Id"),
            "answer_traceparent": answer[1].get("traceparent"),
            "requests_after": after,
            "fault_trace_status": fault_doc and fault_doc["status"],
        }
        if fault[0] != 500 or fault[1].get("X-Trace-Id") != tid \
                or "injected fault" not in json.loads(fault[2])["error"] \
                or http["fault_trace_status"] != "error":
            raise SystemExit("serve.dispatch fault: %s %s"
                             % (json.dumps(http), fault[2][:300]))
        if answer[0] != 200 or answer[1].get("X-Trace-Id") != tid2 or \
                tracing.parse_traceparent(
                    answer[1].get("traceparent", ""))[0] != tid2:
            raise SystemExit("traced /predict: %s" % json.dumps(http))
        answered = np.asarray(json.loads(answer[2])["outputs"][0],
                              np.float32)
        http["answer_equals_alone"] = bool(np.array_equal(answered, alone))
        if not http["answer_equals_alone"] or after != {
                'mxtpu_serve_requests_total{outcome="error"}': 1.0,
                'mxtpu_serve_requests_total{outcome="ok"}': 1.0}:
            raise SystemExit("after the fault: %s" % json.dumps(http))
        if compiles_after != compiles_served:
            raise SystemExit("mxtpu_compile_total moved over the requests: "
                             "%s -> %s" % (compiles_served, compiles_after))
        graphs = ladder.describe()["graphs"]
        if graphs != (list(rungs) if on_card else []) or \
                capture_compiles != (len(graphs) if on_card else 0):
            raise SystemExit("CUDA graphs of rungs %s, %d compile events "
                             "at warm-up" % (graphs, capture_compiles))
        forwards = 2 * len(rungs)
        want = layers * forwards if on_card else 0
        if warm_launches != want:
            raise SystemExit(
                "flash_attention_fwd's wrapper ran %d times at warm-up; want "
                "%d (one eager forward and one capture a rung)"
                % (warm_launches, want))
        # each rung's replay against the eager forward of the same rung
        replay = {}
        for r in rungs:
            feed = tokens[:r]
            got = ladder.dispatch(r, {"data": feed})[0]
            ref = _eager_dispatch(eager[r], feed)
            d = float(np.abs(np.log(got) - np.log(ref)).max())
            walls = {"replay": [], "eager": []}
            for _ in range(SERVE_WALL_ROUNDS):
                for kind in ("replay", "eager", "eager", "replay"):
                    t1 = time.perf_counter()
                    if kind == "replay":
                        ladder.dispatch(r, {"data": feed})
                    else:
                        _eager_dispatch(eager[r], feed)
                    walls[kind].append((time.perf_counter() - t1) * 1e3)
            replay[str(r)] = {
                "max_abs_dlogp": d, "bit_equal": bool(np.array_equal(
                    got, ref)),
                "replay_ms": float(np.median(walls["replay"])),
                "eager_ms": float(np.median(walls["eager"])),
                "replay_ms_all": walls["replay"],
                "eager_ms_all": walls["eager"]}
            if d > TOL_REPLAY:
                raise SystemExit("rung %d: replay vs eager forward max |d "
                                 "log p| = %g > %g" % (r, d, TOL_REPLAY))
        ref = mx.Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                           {"data": (1, seq)}, ctx=check_ctx)
        ref.forward(data=tokens[0:1])
        dlogp = float(np.abs(np.log(ref.get_output(0))
                             - np.log(alone)).max())
        if dlogp > 1e-3:
            raise SystemExit("served vs %s recomputation: max |d log p| = %g"
                             % (check_ctx, dlogp))
    return {"config": cfg, "context": str(ctx), "requests": 8,
            "request_rows": [1] * 6 + [3, 1],
            "dispatches_per_rung": {str(k): v for k, v in counts.items()},
            "window_dispatches": replays, "launches": launches,
            "launches_per_dispatch": launches / replays,
            "capture_launches": warm_launches, "capture_forwards": forwards,
            "graphs": graphs,
            "capture_compiles": capture_compiles, "ladder_s": ladder_s,
            "warm_wall_ms": warm_ms,
            "ewma_wall_ms": ladder.describe()["wall_ms"],
            "replay_vs_eager": replay, "memory": mem,
            "serve_s": serve_s, "alone_vs_coalesced_dlogp": alone_err,
            "metrics_delta": counted, "health": verdict["health"],
            "http": http, "compile_total": compiles_after,
            "cross_check": str(check_ctx), "max_abs_dlogp": dlogp,
            "peak_mem_bytes": mem.get("graph_peak_bytes"),
            "profile": profile}


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


def flash_source_counts():
    """The flash forward's and backward's launches by source: the f32
    (``flash_attention_fwd``) and the bf16 (``flash_attention_fwd_sm90``)
    kernels apart, keyed as the kernels line names them."""
    return dict(flash_attention_fwd.source_launches,
                **flash_attention_bwd.source_launches)


def zero_flash_counts():
    flash_attention_fwd.launches = 0
    flash_attention_bwd.launches = 0
    flash_attention_delta.launches = 0
    for counts in (flash_attention_fwd.source_launches,
                   flash_attention_bwd.source_launches):
        for name in counts:
            counts[name] = 0


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
        flash_attention_fwd.launches = 0
        flash_attention_bwd.launches = 0
        flash_attention_delta.launches = 0
        with tf32_mode(tf32):
            loss = float(trainer.step(batch))
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
    checkpoint written, its CRC manifest verified, and loaded by
    ``Module.load`` on ``ctx``, and a second score equal to the first
    within 1e-6.  The bigram must be
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
        manifest = mx.resilience.verify_manifest(prefix, 1)
        if manifest is None or list(manifest["files"]) != [
                "gpt-0001.params"]:
            raise SystemExit("module_train: the checkpoint's manifest %s"
                             % manifest)
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
                          "manifest_verified": True,
                          "manifest_arrays": len(manifest["arrays"]),
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
        zero_flash_counts()
        with tf32_mode(tf32):
            mod.forward_backward(b)
            mod.update()
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
        zero_kernel_counts()
        mod, it, run = lstm_bucketing.fit(
            ctx, cfg["vocab"], cfg["num_hidden"], cfg["num_embed"],
            cfg["num_layers"], cfg["batch_size"], epochs, lr=lr,
            sentences=sentences, val_sentences=val_sentences,
            disp_batches=40)
        launches = kernel_counts()
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
        with tf32_mode(tf32):
            for b in batches:
                mod.forward_backward(b)
                mod.update()
                m = mx.metric.Perplexity(lstm_bucketing.INVALID_LABEL)
                m.update(b.label, mod.get_outputs())
                ppl.append(m.get()[1])
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


# ------------------------------------------ the imperative surface and DCGAN
#: op_corpus: the worst relative error (of max |CPU's|) an op's outputs or
#: gradient may show on the card against the CPU in f32 with TF32 off;
#: exact cases (indices, 0/1 results, sorted values) must agree in every
#: bit
TOL_OP_CORPUS = 1e-5
#: a sampler's mean and variance within this many standard errors
TOL_SAMPLER_Z = 6.0
#: the corpus's ops that reach cuBLAS or cuDNN: run again with TF32 on as
#: op_corpus's control, their worst error must exceed TOL_OP_CORPUS
TF32_CONTROL_OPS = ("dot", "batch_dot", "Convolution", "Deconvolution",
                    "LSoftmax")
#: op_corpus's ``test_utils.check_consistency`` of a DCGAN block: every
#: output and gradient, element by element (rtol = atol); the same check
#: with TF32 in cuBLAS and cuDNN, run as a control, must miss it
TOL_CONSISTENCY = 1e-4
#: the block's input (N, C, H, W): 64 channels, so that each output sums
#: hundreds of products and TF32's rounding shows; parameters drawn at
#: this scale, the moving variance 1 (with check_consistency's default of
#: 0 the inference BatchNorm scales by 1/sqrt(eps), and cancellation in
#: the f32 sums alone reads 3.7e-4 on the card)
CONSISTENCY_SHAPE = (8, 64, 8, 8)
CONSISTENCY_SCALE = 0.1
#: autograd_check (a): the imperative MLP's losses and weight changes on
#: the card against the CPU after AUTOGRAD_STEPS steps, relative
TOL_AUTOGRAD_CHECK = 1e-4
AUTOGRAD_WIDTHS = (784, 128, 64, 10)       # train_mnist.py's MLP
AUTOGRAD_BATCH = 100
AUTOGRAD_STEPS = 20
AUTOGRAD_FLASH = (4, 1024, 16, 64)         # B, T, H, D: K1's serving shape
#: the reference MXNet example/gan/dcgan.py's widths: a 512-256-128-64-3
#: generator (ngf 32 in make_dcgan_sym: its top layer is 16 ngf at size 64)
#: and a 64-128-256-512-1 discriminator, 64x64x3, z 100, batch 64, Adam
#: 2e-4 with beta1 0.5; trained two epochs of 2048 made images
DCGAN_FULL = {"size": 64, "ngf": 32, "ndf": 64, "nc": 3, "z": 100,
              "batch_size": 64, "images": 2048, "epochs": 2}
DCGAN_PARAMS = (3576704, 2765568)           # generator, discriminator
#: dcgan_check: three iterations at size 16 on the card and the CPU
DCGAN_CHECK = {"size": 16, "ngf": 8, "ndf": 8, "nc": 3, "z": 16,
               "batch_size": 8, "iterations": 3}
TOL_DCGAN_CHECK = 1e-4
TOL_DCGAN_CHECK_AUX = 1e-4


def dcgan_block():
    """Deconvolution -> BatchNorm -> LeakyReLU -> Convolution, as the DCGAN
    stacks them (64 channels in, 32 after the Deconvolution, 16 out)."""
    x = mx.sym.Variable("x")
    y = mx.sym.Deconvolution(x, name="dc", kernel=(4, 4), stride=(2, 2),
                             pad=(1, 1), num_filter=32)
    y = mx.sym.BatchNorm(y, name="bn", fix_gamma=False)
    y = mx.sym.LeakyReLU(y, name="act", act_type="leaky", slope=0.2)
    return mx.sym.Convolution(y, name="cv", kernel=(3, 3), pad=(1, 1),
                              num_filter=16)


def op_corpus_phase(device="cuda", check_device="cpu"):
    """Every case of ``tools/op_corpus.py`` but the detection path's and
    the dense contrib ops' (``detection_ops_phase`` and
    ``contrib_ops_phase`` hold those; each op the dense corpus
    registers, the 1-d and 3-d Convolution and Pooling, ``LayerNorm
    output_mean_var``; ties planted) on ``device`` and on ``check_device``
    from the same seeded inputs in f32, TF32 off: the outputs and the
    gradient of ``sum(out * cot)`` within ``TOL_OP_CORPUS``, the exact
    cases to the bit (sort, argsort and topk indices included); then each
    sampler twice from one seed (the same bits) with its mean and
    variance within ``TOL_SAMPLER_Z`` standard errors.  No kernel is
    launched.  On the card the cases of ``TF32_CONTROL_OPS`` run again
    with TF32 in cuBLAS and cuDNN as a control, which must miss the
    bound.  Last, ``test_utils.check_consistency`` binds
    :func:`dcgan_block` on both devices from the same parameters and
    holds every output and gradient within ``TOL_CONSISTENCY``; on the
    card its TF32 control must miss that bound."""
    t0 = time.perf_counter()
    zero_kernel_counts()
    rows = op_corpus.card_vs_cpu(
        device, check_device=check_device,
        exclude=op_corpus.DETECTION_OPS | op_corpus.CONTRIB_OPS)
    samplers = op_corpus.sampler_check(device)
    counts = kernel_counts()
    ctxs = [mx.context.context_of(torch.device(d))
            for d in (device, check_device)]

    def consistency(raise_on_err=True):
        return test_utils.check_consistency(
            dcgan_block(), [dict(ctx=c, x=CONSISTENCY_SHAPE) for c in ctxs],
            scale=CONSISTENCY_SCALE, tol=TOL_CONSISTENCY,
            aux_params={"bn_moving_mean": np.zeros(32),
                        "bn_moving_var": np.ones(32)},
            raise_on_err=raise_on_err)["max_err"]

    consistency_err = consistency()
    control = consistency_control = None
    if torch.device(device).type == "cuda":
        with tf32_mode():
            control = op_corpus.card_vs_cpu(
                device, check_device=check_device, ops=TF32_CONTROL_OPS)
            consistency_control = consistency(raise_on_err=False)

    def worst(r):
        return max(r["out_err"], r["grad_err"] or 0.0)

    over = [r for r in rows if worst(r) > TOL_OP_CORPUS]
    bad_samplers = [s for s in samplers if not s["same_bits"]
                    or s["mean_z"] > TOL_SAMPLER_Z
                    or s["var_z"] > TOL_SAMPLER_Z]
    by_op = {}
    for r in rows:
        by_op[r["op"]] = max(by_op.get(r["op"], 0.0), worst(r))
    out = {"devices": [str(device), str(check_device)],
           "ops": len(by_op) + len({s["op"] for s in samplers}),
           "cases": len(rows), "exact_cases": sum(r["exact"] for r in rows),
           "worst5": sorted(by_op.items(), key=lambda kv: -kv[1])[:5],
           "over": over, "tol": TOL_OP_CORPUS, "samplers": samplers,
           "consistency": {"graph": "dcgan_block",
                           "x": list(CONSISTENCY_SHAPE),
                           "scale": CONSISTENCY_SCALE,
                           "max_err": consistency_err,
                           "tol": TOL_CONSISTENCY,
                           "control_tf32_max_err": consistency_control},
           "sampler_tol_z": TOL_SAMPLER_Z, "kernel_launches": counts,
           "control_tf32": None if control is None else {
               "cases": len(control), "worst": max(worst(r)
                                                   for r in control)},
           "seconds": time.perf_counter() - t0}
    if over or bad_samplers or any(counts.values()):
        raise SystemExit("op_corpus: %s" % json.dumps(out))
    if control is not None and out["control_tf32"]["worst"] \
            <= TOL_OP_CORPUS:
        raise SystemExit("op_corpus: the TF32 control passes the bound, "
                         "so it cannot tell TF32 from f32: %s"
                         % json.dumps(out))
    if consistency_control is not None \
            and consistency_control <= TOL_CONSISTENCY:
        raise SystemExit("op_corpus: check_consistency's TF32 control "
                         "passes its bound: %s" % json.dumps(out))
    return out


def _mlp_weights(widths, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for fan_in, fan_out in zip(widths[:-1], widths[1:]):
        out.append(rng.normal(0, fan_in ** -0.5, (fan_out, fan_in))
                   .astype(np.float32))
        out.append(np.zeros(fan_out, np.float32))
    return out


def imperative_mlp(ctx, widths=AUTOGRAD_WIDTHS, batch=AUTOGRAD_BATCH,
                   steps=AUTOGRAD_STEPS, lr=0.01, seed=0):
    """The verify skill's imperative loop: ``mark_variables``, then each
    step ``autograd.record()`` over FullyConnected/Activation/
    SoftmaxOutput, ``autograd.backward`` and ``nd.sgd_update(out=w)``, on
    made data (one batch of ``batch`` rows, labels from a fixed linear
    map).  Returns (losses, weight changes)."""
    rng = np.random.RandomState(seed + 1)
    x0 = rng.normal(0, 1, (batch, widths[0])).astype(np.float32)
    y0 = np.argmax(x0 @ rng.normal(0, 1, (widths[0], widths[-1])), 1) \
        .astype(np.float32)
    init = _mlp_weights(widths, seed)
    params = [mx.nd.array(w, ctx=ctx) for w in init]
    grads = [mx.nd.zeros_like(p) for p in params]
    mx.autograd.mark_variables(params, grads)
    x, y = mx.nd.array(x0, ctx=ctx), mx.nd.array(y0, ctx=ctx)
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            h = x
            for i in range(len(widths) - 1):
                h = mx.nd.FullyConnected(h, params[2 * i], params[2 * i + 1],
                                         num_hidden=widths[i + 1])
                if i < len(widths) - 2:
                    h = mx.nd.Activation(h, act_type="relu")
            out = mx.nd.SoftmaxOutput(h, y)
        mx.autograd.backward([out])
        p = out.asnumpy()[np.arange(batch), y0.astype(int)]
        losses.append(float(-np.log(np.maximum(p, 1e-30)).mean()))
        for w, g in zip(params, grads):
            mx.nd.sgd_update(w, g, out=w, lr=lr)
    return losses, {"p%d" % i: torch.from_numpy(w.asnumpy() - w0)
                    for i, (w, w0) in enumerate(zip(params, init))}


def autograd_check_phase(ctx, check_ctx=None, widths=AUTOGRAD_WIDTHS,
                         batch=AUTOGRAD_BATCH, steps=AUTOGRAD_STEPS,
                         flash=AUTOGRAD_FLASH):
    """(a) :func:`imperative_mlp` at ``train_mnist.py``'s widths on
    ``ctx`` and ``check_ctx`` (default: the CPU) from the same weights:
    losses and each weight's change within ``TOL_AUTOGRAD_CHECK``, and on
    the card the same loop with TF32 matmuls, run as a control, must miss
    it.  (b) ``nd._contrib_FlashAttention`` recorded in f32 on ``flash``
    (B, T, H, D) causal and differentiated by ``autograd.backward`` with a
    seeded head gradient: on the card K1 and K3 launch once each (the
    delta kernel once), nothing else; dQ, dK and dV equal, bit for bit,
    the Executor route's on the same inputs."""
    check_ctx = check_ctx or mx.cpu()
    on_card = ctx.device_type == "gpu"
    t0 = time.perf_counter()
    losses, delta = imperative_mlp(ctx, widths, batch, steps)
    ref_losses, ref_delta = imperative_mlp(check_ctx, widths, batch, steps)
    loss_diff = float(np.max(np.abs(np.subtract(losses, ref_losses))
                             / np.abs(ref_losses)))
    mlp = {"widths": list(widths), "batch": batch, "steps": steps,
           "losses": [losses, ref_losses], "max_rel_loss_diff": loss_diff,
           **update_diff(delta, ref_delta), "tol": TOL_AUTOGRAD_CHECK,
           "control_tf32": None}
    if on_card:
        with tf32_mode():
            tf32_losses, tf32_delta = imperative_mlp(ctx, widths, batch,
                                                     steps)
        mlp["control_tf32"] = dict(
            update_diff(tf32_delta, ref_delta), max_rel_loss_diff=float(
                np.max(np.abs(np.subtract(tf32_losses, ref_losses))
                       / np.abs(ref_losses))))

    b, t, h, d = flash
    rng = np.random.RandomState(3)
    qkv = [rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
           for _ in range(3)]
    dout = rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
    arrs = [mx.nd.array(v, ctx=ctx) for v in qkv]
    for a in arrs:
        a.attach_grad()
    zero_kernel_counts()
    with mx.autograd.record():
        o = mx.nd._contrib_FlashAttention(*arrs, causal=True)
    mx.autograd.backward([o], [mx.nd.array(dout, ctx=ctx)])
    mx.nd.waitall()
    counts = kernel_counts()
    by_source = flash_source_counts()
    names = ("q", "k", "v")
    sym = mx.sym._contrib_FlashAttention(
        *[mx.sym.Variable(n) for n in names], causal=True)
    exe = sym.bind(ctx, {n: mx.nd.array(v, ctx=ctx)
                         for n, v in zip(names, qkv)})
    exe.forward(is_train=True)
    exe.backward([mx.nd.array(dout, ctx=ctx)])
    same = {n: bool(torch.equal(a.grad.data, exe.grad_dict[n].data))
            for n, a in zip(names, arrs)}
    out_same = bool(torch.equal(o.data, exe.outputs[0].data))
    flash_out = {"shape": list(flash), "dtype": "float32", "causal": True,
                 "launches": counts, "source_launches": by_source,
                 "grads_equal_executor": same,
                 "output_equal_executor": out_same}
    out = {"contexts": [str(ctx), str(check_ctx)], "mlp": mlp,
           "flash": flash_out, "seconds": time.perf_counter() - t0}
    bad = []
    if max(loss_diff, mlp["max_rel_update_diff"]) > TOL_AUTOGRAD_CHECK \
            or not np.isfinite(losses + ref_losses).all() \
            or not losses[-1] < losses[0]:
        bad.append("the imperative loop")
    control = mlp["control_tf32"]
    if control is not None and max(
            control["max_rel_update_diff"],
            control["max_rel_loss_diff"]) <= TOL_AUTOGRAD_CHECK:
        bad.append("the TF32 control passes the bound")
    want = dict.fromkeys(counts, 0)
    if on_card:
        want.update(flash_attention_fwd=1, flash_attention_bwd=1,
                    flash_attention_delta=1)
    if counts != want:
        bad.append("launches %s, want %s" % (counts, want))
    want_source = dict.fromkeys(by_source, 0)
    if on_card:
        want_source.update(flash_attention_fwd=1, flash_attention_bwd=1)
    if by_source != want_source:
        bad.append("launches by source %s, want %s" % (by_source,
                                                        want_source))
    if not all(same.values()) or not out_same:
        bad.append("the autograd route differs from the Executor's")
    if bad:
        raise SystemExit("autograd_check: %s: %s" % ("; ".join(bad),
                                                      json.dumps(out)))
    return out


def _dcgan_args(cfg, **over):
    cfg = dict(cfg, **over)
    return dcgan.parse_args([
        "--size", str(cfg["size"]), "--ngf", str(cfg["ngf"]),
        "--ndf", str(cfg["ndf"]), "--nc", str(cfg["nc"]),
        "--z", str(cfg["z"]), "--batch-size", str(cfg["batch_size"]),
        "--images", str(cfg["images"]), "--epochs", str(cfg["epochs"]),
        "--log-every", "8"])


def dcgan_train_phase(ctx, cfg=DCGAN_FULL, params=DCGAN_PARAMS):
    """The DCGAN of ``tools/dcgan.py`` (the Module API: Deconvolution,
    BatchNorm, LeakyReLU, LogisticRegressionOutput, ``+=`` on gradient
    arrays, input gradients into the generator's backward) at ``cfg``'s
    widths on ``ctx`` for its epochs, the kernel counts set to 0 just
    before and read just after (no kernel lies on this path).  Checks:
    the parameter counts (``params``, when given), every parameter finite,
    every iteration run, every count 0.  Reports the median ms of an
    iteration past the first epoch (synchronized), images/s, peak memory
    and the discriminator's accuracy history."""
    if ctx.device_type == "gpu":
        gc.collect()
        torch.cuda.empty_cache()
    args = _dcgan_args(cfg)
    t0 = time.perf_counter()
    zero_kernel_counts()
    out, _g, _d = dcgan.run(args, ctx)
    out["kernel_launches"] = counts = kernel_counts()
    out["flash_source_launches"] = by_source = flash_source_counts()
    out["seconds"] = time.perf_counter() - t0
    if ctx.device_type == "gpu":
        out["nvidia_smi"] = nvidia_smi()
    bad = []
    if params is not None and (out["generator_params"],
                               out["discriminator_params"]) != params:
        bad.append("parameters %d + %d, want %d + %d" % (
            out["generator_params"], out["discriminator_params"], *params))
    if not out["finite"]:
        bad.append("a parameter is not finite")
    if out["iterations"] != cfg["epochs"] * (cfg["images"]
                                             // cfg["batch_size"]):
        bad.append("%d iterations" % out["iterations"])
    if any(counts.values()) or any(by_source.values()):
        bad.append("a kernel launched: %s %s" % (counts, by_source))
    if bad:
        raise SystemExit("dcgan_train: %s: %s" % ("; ".join(bad),
                                                   json.dumps(out)))
    return out


def dcgan_check_phase(ctx, cfg=DCGAN_CHECK, check_ctx=None):
    """``cfg["iterations"]`` iterations of ``tools/dcgan.py``'s loop at
    ``cfg``'s size in f32 on ``ctx`` and on ``check_ctx`` (default: the
    CPU) from the same initial parameters, noise and images: per leaf of
    the generator and the discriminator ||change - CPU's|| / ||CPU's||
    within ``TOL_DCGAN_CHECK``, and per BatchNorm moving statistic within
    ``TOL_DCGAN_CHECK_AUX``; on the card the same iterations with TF32 in
    cuBLAS and cuDNN both, run as a control, must miss a bound."""
    check_ctx = check_ctx or mx.cpu()
    t0 = time.perf_counter()
    args = _dcgan_args(dict(cfg, epochs=1,
                            images=cfg["batch_size"] * cfg["iterations"]))
    kw = dict(batch_size=args.batch_size, size=args.size, ngf=args.ngf,
              ndf=args.ndf, nc=args.nc, z=args.z, lr=args.lr,
              beta1=args.beta1, n_images=args.images, log_every=1)
    g0, d0, _h = dcgan.train(epochs=0, ctx=mx.cpu(), **kw)
    init = [{k: v.asnumpy() for k, v in d.items()}
            for m in (g0, d0) for d in m.get_params()]

    def run(c, tf32=False):
        with tf32_mode(tf32):
            g, d, hist = dcgan.train(epochs=1, ctx=c, init=init, **kw)
        now = [{k: v.asnumpy() for k, v in p.items()}
               for m in (g, d) for p in m.get_params()]
        arg = {k: torch.from_numpy(v - i[k])
               for n, i in zip(now[0::2], init[0::2]) for k, v in n.items()}
        aux = {k: torch.from_numpy(v - i[k])
               for n, i in zip(now[1::2], init[1::2]) for k, v in n.items()}
        return hist, arg, aux

    hist, arg, aux = run(ctx)
    ref_hist, ref_arg, ref_aux = run(check_ctx)
    moved = {k for k, v in ref_arg.items() if v.norm().item() > 0}
    out = {"config": cfg, "contexts": [str(ctx), str(check_ctx)],
           "d_accuracy": [hist, ref_hist],
           "params": update_diff({k: arg[k] for k in moved},
                                 {k: ref_arg[k] for k in moved}, True),
           "aux": update_diff(aux, ref_aux, True),
           "tol": TOL_DCGAN_CHECK, "tol_aux": TOL_DCGAN_CHECK_AUX,
           "control_tf32": None}
    if ctx.device_type == "gpu":
        _h, t_arg, t_aux = run(ctx, tf32=True)
        out["control_tf32"] = {
            "params": update_diff({k: t_arg[k] for k in moved},
                                  {k: ref_arg[k] for k in moved}),
            "aux": update_diff(t_aux, ref_aux)}
    out["seconds"] = time.perf_counter() - t0

    def within(o):
        return o["params"]["max_rel_update_diff"] <= TOL_DCGAN_CHECK \
            and o["aux"]["max_rel_update_diff"] <= TOL_DCGAN_CHECK_AUX

    if not within(out):
        raise SystemExit("dcgan_check: %s" % json.dumps(out))
    if out["control_tf32"] is not None and within(out["control_tf32"]):
        raise SystemExit("dcgan_check: the TF32 control passes both bounds, "
                         "so they cannot tell it from f32: %s"
                         % json.dumps(out))
    return out


# ------------------------------------------------------- the detection path
#: SSD300's feature maps (relu4_3, relu7 and four more) and its anchors:
#: 37^2*4 + 18^2*6 + 9^2*6 + 5^2*6 + 3^2*4 + 2^2*4
SSD300_MAPS = (37, 18, 9, 5, 3, 2)
SSD300_ANCHORS = 8108
#: the batch and the padded label rows of the MultiBox ops' checks
DET_BATCH = 32
DET_LABEL_ROWS = 4
#: the R-CNN's Proposal and ROIPooling: (1, 2A, 12, 12) scores at stride 8
#: of a 96x96 image, anchors of scales 2 and 4, 400 boxes kept before NMS
#: and 64 after; 32 rois pooled to 4x4 from 64 channels
RCNN_PROPOSAL = {"feature_stride": 8, "scales": (2, 4), "ratios": (1.0,),
                 "rpn_pre_nms_top_n": 400, "rpn_post_nms_top_n": 64,
                 "threshold": 0.7, "rpn_min_size": 4}
#: the largest absolute difference of a float output of the detection ops
#: on the card from the CPU's (boxes in [0, 1] units or, for Proposal, in
#: pixels of a 96-pixel image; the card's exp and log differ from the
#: CPU's in the last bits); integer-valued outputs (class targets, masks,
#: class ids, the survivors of NMS) must be equal
TOL_DETECTION = 1e-4
TOL_PROPOSAL = 1e-3
#: ssd_train: SSD300 over VGG16 reduced at examples/ssd/train.py's
#: defaults (20 classes, 300x300, batch 32, SGD 0.004, momentum 0.9, wd
#: 5e-4, clip 4, Xavier gaussian out 2) for two epochs of 512 made
#: 300-px records
SSD_FULL = {"network": "vgg16_reduced", "num_classes": 20,
            "data_shape": 300, "batch_size": 32, "images": 512,
            "image_size": 300, "epochs": 2}
SSD_PARAMS = 26284974
#: ssd_check: one f32 step of ssd_mini at 96 px, batch 8, card against
#: CPU; then ssd_mini trained as tests/test_ssd_e2e.py:132-152 trains it
#: (24 made 96-px images, batch 8, 40 epochs, lr 0.05, no mirror, mean
#: 128) to a VOC07 mAP above TOL_SSD_MAP through evaluate_net
SSD_CHECK = {"data_shape": 96, "batch_size": 8, "images": 24,
             "epochs": 40, "lr": 0.05}
#: the step's worst leaf, ||card's change - CPU's|| / ||CPU's||: the card
#: read 2.46e-3 (a BatchNorm beta, whose gradient is a sum that cancels;
#: the median leaf 5.2e-7) and its TF32 control 6.0e-2; a convolution's
#: bias ahead of a BatchNorm, in units of lr: 2.8e-8
TOL_SSD_CHECK = 1e-2
TOL_SSD_CHECK_LR = 1e-4
TOL_SSD_MAP = 0.35
#: rcnn_train: tools/rcnn.py at the example's configuration, one epoch of
#: its 200 images, then evaluate on its 50
RCNN_FULL = {"epochs": 1, "images": 200, "test_images": 50}


def _prior_anchors(device, maps=SSD300_MAPS, sizes=None, ratios=None):
    """The anchors MultiBoxPrior gives SSD300's feature maps, concatenated
    as the training symbol concatenates them: (1, A, 4)."""
    sizes = sizes or ssd.DEFAULT_SIZES
    ratios = ratios or ssd.DEFAULT_RATIOS
    op = get_op("_contrib_MultiBoxPrior")
    out = []
    for m, s, r in zip(maps, sizes, ratios):
        attrs = op.parse_attrs({"sizes": str(tuple(s)),
                                "ratios": str(tuple(r))})
        out.append(op.fcompute(attrs, OpContext(), torch.zeros(
            1, 1, m, m, device=device)))
    return torch.cat(out, dim=1)


def _det_inputs(batch, anchors, classes=21, rows=DET_LABEL_ROWS, seed=0):
    """MultiBoxTarget's and MultiBoxDetection's inputs at SSD's shapes:
    padded labels (1 to ``rows`` objects an image), class scores and
    location offsets drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    label = np.full((batch, rows, 6), -1.0, np.float32)
    for b in range(batch):
        for m in range(rng.randint(1, rows + 1)):
            c = rng.uniform(0.15, 0.85, 2)
            wh = rng.uniform(0.05, 0.5, 2)
            label[b, m] = [rng.randint(0, classes - 1), *(c - wh / 2),
                           *(c + wh / 2), 0]
    cls_pred = rng.normal(0, 1, (batch, classes, anchors)).astype(np.float32)
    logits = rng.normal(0, 2, (batch, classes, anchors))
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
    loc = rng.normal(0, 0.5, (batch, anchors * 4)).astype(np.float32)
    return label, cls_pred, prob, loc


def _run_op(name, attrs, device, *inputs):
    op = get_op(name)
    out = op.fcompute(op.parse_attrs({k: str(v) for k, v in attrs.items()}),
                      OpContext(device=torch.device(device)),
                      *[x if torch.is_tensor(x) else torch.from_numpy(x)
                        .to(device) for x in inputs])
    return out if isinstance(out, tuple) else (out,)


def _max_abs(a, b):
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def _sync_free(fn):
    """None when ``fn()`` makes no host sync on the card (sync-debug mode
    "error" around it), else the error's first line."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return None


SSD_TARGET = {"overlap_threshold": 0.5, "ignore_label": -1,
              "negative_mining_ratio": 3, "minimum_negative_samples": 0,
              "negative_mining_thresh": 0.5,
              "variances": (0.1, 0.1, 0.2, 0.2)}
SSD_DETECTION = {"nms_threshold": 0.45, "force_suppress": False,
                 "variances": (0.1, 0.1, 0.2, 0.2), "nms_topk": 400}


def detection_ops_phase(device="cuda", check_device="cpu", batch=DET_BATCH,
                        maps=SSD300_MAPS, repeats=5):
    """The ten ops of the detection path on ``device`` against
    ``check_device``: (a) the op corpus's cases of them (TOL_OP_CORPUS,
    the exact cases to the bit, gradients included); (b) MultiBoxPrior,
    MultiBoxTarget (hard negative mining 3:1) and MultiBoxDetection (NMS
    over the 400 best) at SSD300's 8108 anchors and batch ``batch`` with
    padded labels: anchors, offsets and boxes within TOL_DETECTION, the
    masks, class targets and detected class ids equal; (c) Proposal and
    ROIPooling at the R-CNN's shapes, the rois within TOL_PROPOSAL, the
    pooled values and their gradient within TOL_OP_CORPUS.  On the card
    each MultiBox op's ms and the NMS loop's (CUDA events), and one
    forward each of MultiBoxTarget, MultiBoxDetection and Proposal under
    ``torch.cuda.set_sync_debug_mode("error")`` after a warm call: none
    may sync the host.  No kernel is launched."""
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    zero_kernel_counts()
    rows = op_corpus.card_vs_cpu(device, check_device=check_device,
                                 ops=op_corpus.DETECTION_OPS)
    over = [r for r in rows
            if max(r["out_err"], r["grad_err"] or 0.0) > TOL_OP_CORPUS]

    anchors = _prior_anchors(device, maps)
    ref_anchors = _prior_anchors(check_device, maps)
    n_anchors = anchors.shape[1]
    label, cls_pred, prob, loc = _det_inputs(batch, n_anchors)
    tgt = _run_op("_contrib_MultiBoxTarget", SSD_TARGET, device, anchors,
                  label, cls_pred)
    ref_tgt = _run_op("_contrib_MultiBoxTarget", SSD_TARGET, check_device,
                      ref_anchors, label, cls_pred)
    det = _run_op("_contrib_MultiBoxDetection", SSD_DETECTION, device, prob,
                  loc, anchors)[0]
    ref_det = _run_op("_contrib_MultiBoxDetection", SSD_DETECTION,
                      check_device, prob, loc, ref_anchors)[0]
    multibox = {
        "batch": batch, "anchors": n_anchors,
        "label_rows": DET_LABEL_ROWS,
        "prior_max_abs": _max_abs(anchors, ref_anchors),
        "target_loc_max_abs": _max_abs(tgt[0], ref_tgt[0]),
        "target_mask_equal": bool(torch.equal(tgt[1].cpu(),
                                              ref_tgt[1].cpu())),
        "target_cls_equal": bool(torch.equal(tgt[2].cpu(),
                                             ref_tgt[2].cpu())),
        "positives": int((ref_tgt[2] > 0).sum()),
        "negatives": int((ref_tgt[2] == 0).sum()),
        "detection_ids_equal": bool(torch.equal(det[..., 0].cpu(),
                                                ref_det[..., 0].cpu())),
        "detection_max_abs": _max_abs(det[..., 1:], ref_det[..., 1:]),
        "kept": int((ref_det[..., 0] >= 0).sum())}

    rng = np.random.RandomState(1)
    a = len(RCNN_PROPOSAL["scales"]) * len(RCNN_PROPOSAL["ratios"])
    fg = rng.uniform(0, 1, (1, a, 12, 12)).astype(np.float32)
    rpn = [np.concatenate([1 - fg, fg], 1),
           rng.normal(0, 0.1, (1, 4 * a, 12, 12)).astype(np.float32),
           np.array([[96, 96, 1.0]], np.float32)]
    rois = _run_op("_contrib_Proposal", RCNN_PROPOSAL, device, *rpn)[0]
    ref_rois = _run_op("_contrib_Proposal", RCNN_PROPOSAL, check_device,
                       *rpn)[0]
    feat = np.maximum(rng.normal(0, 1, (1, 64, 12, 12)), 0).astype(
        np.float32)
    cot = rng.normal(0, 1, (32, 64, 4, 4)).astype(np.float32)

    def pooled(dev, r):
        x = torch.from_numpy(feat).to(dev).requires_grad_()
        out = _run_op("ROIPooling", {"pooled_size": (4, 4),
                                     "spatial_scale": 1.0 / 8}, dev, x,
                      r[:32].to(dev))[0]
        (out * torch.from_numpy(cot).to(dev)).sum().backward()
        return out.detach(), x.grad
    pool, pool_grad = pooled(device, ref_rois)
    ref_pool, ref_pool_grad = pooled(check_device, ref_rois)
    rcnn_ops = {"proposal_rois_max_abs": _max_abs(rois, ref_rois),
                "roi_pooling_max_abs": _max_abs(pool, ref_pool),
                "roi_pooling_grad_max_abs": _max_abs(pool_grad,
                                                     ref_pool_grad)}
    out = {"devices": [str(device), str(check_device)],
           "corpus": {"cases": len(rows), "ops": sorted(
               {get_op(c["op"]).name for c in rows}), "over": over,
               "worst": max(max(r["out_err"], r["grad_err"] or 0.0)
                            for r in rows)},
           "multibox": multibox, "rcnn_ops": rcnn_ops,
           "tol": TOL_DETECTION, "tol_proposal": TOL_PROPOSAL}
    if on_card:
        t_anchors = _prior_anchors(device, maps)
        tl, tc, tp, tloc = (torch.from_numpy(x).to(device)
                            for x in (label, cls_pred, prob, loc))
        target_op = get_op("_contrib_MultiBoxTarget")
        target_attrs = target_op.parse_attrs(SSD_TARGET)
        det_op = get_op("_contrib_MultiBoxDetection")
        det_attrs = det_op.parse_attrs(SSD_DETECTION)
        prop_op = get_op("_contrib_Proposal")
        prop_attrs = prop_op.parse_attrs(RCNN_PROPOSAL)
        rpn_t = [torch.from_numpy(x).to(device) for x in rpn]
        ctx = OpContext(device=torch.device(device))
        calls = {
            "multibox_prior": lambda: _prior_anchors(device, maps),
            "multibox_target": lambda: target_op.fcompute(
                target_attrs, ctx, t_anchors, tl, tc),
            "multibox_detection": lambda: det_op.fcompute(
                det_attrs, ctx, tp, tloc, t_anchors),
            "proposal": lambda: prop_op.fcompute(prop_attrs, ctx, *rpn_t)}
        out["ms"] = {k: cuda_ms(f, repeats) for k, f in calls.items()}
        k = SSD_DETECTION["nms_topk"]
        alive = torch.rand(batch, k, device=device) < 0.5
        sup = torch.rand(batch, k, k, device=device).triu(1) > 0.9
        from mxnet_tpu_torch.ops.contrib import suppress_greedy
        out["ms"]["nms_loop"] = cuda_ms(lambda: suppress_greedy(alive, sup),
                                        repeats)
        out["sync_debug"] = {k: _sync_free(calls[k]) for k in (
            "multibox_target", "multibox_detection", "proposal")}
        out["nvidia_smi"] = nvidia_smi()
    out["kernel_launches"] = counts = kernel_counts()
    out["seconds"] = time.perf_counter() - t0
    bad = []
    if over:
        bad.append("corpus cases over the bound")
    if max(multibox["prior_max_abs"], multibox["target_loc_max_abs"],
           multibox["detection_max_abs"]) > TOL_DETECTION:
        bad.append("a MultiBox float output")
    if not (multibox["target_mask_equal"] and multibox["target_cls_equal"]
            and multibox["detection_ids_equal"]):
        bad.append("a MultiBox integer output")
    if rcnn_ops["proposal_rois_max_abs"] > TOL_PROPOSAL:
        bad.append("Proposal's rois")
    if max(rcnn_ops["roi_pooling_max_abs"],
           rcnn_ops["roi_pooling_grad_max_abs"]) > TOL_OP_CORPUS:
        bad.append("ROIPooling")
    if any(out.get("sync_debug", {}).values()):
        bad.append("a host sync")
    if any(counts.values()):
        bad.append("a kernel launched")
    if bad:
        raise SystemExit("detection_ops: %s: %s" % ("; ".join(bad),
                                                     json.dumps(out)))
    return out


def _ssd_args(cfg, **over):
    cfg = dict(cfg, **over)
    return ssd.parse_args([
        "--network", cfg["network"], "--num-classes",
        str(cfg["num_classes"]), "--data-shape", str(cfg["data_shape"]),
        "--batch-size", str(cfg["batch_size"]), "--images",
        str(cfg["images"]), "--image-size", str(cfg["image_size"]),
        "--num-epochs", str(cfg["epochs"])])


def ssd_train_phase(ctx, workdir, cfg=SSD_FULL):
    """``tools/ssd.py`` (``train_net``: DetRecordIter, the MultiBox ops,
    Module.fit) at ``cfg`` on ``ctx`` from records made in ``workdir``,
    the kernel counts set to 0 just before and read just after (no kernel
    lies on this path).  Checks: the parameter count (``cfg["params"]``,
    default SSD_PARAMS, when not None), every parameter finite, the
    second epoch's CrossEntropy and SmoothL1 below the first's, every
    count 0.  Reports the tool's JSON fields: the median ms of a batch
    past the first epoch, images/s, the share of a batch in
    ``DetRecordIter.next``, peak memory."""
    if ctx.device_type == "gpu":
        gc.collect()
        torch.cuda.empty_cache()
    params = cfg.get("params", SSD_PARAMS)
    args = _ssd_args(cfg)
    rec = os.path.join(workdir, "ssd_train.rec")
    t0 = time.perf_counter()
    ssd.make_record_file(rec, args.images, args.image_size, args.max_objects,
                         seed=args.seed, num_classes=args.num_classes)
    records_s = time.perf_counter() - t0
    zero_kernel_counts()
    calls = mx.operator.Custom.host_calls
    out, _mod = ssd.run(args, ctx, rec)
    out["kernel_launches"] = counts = kernel_counts()
    out["flash_source_launches"] = by_source = flash_source_counts()
    out["custom_host_calls"] = mx.operator.Custom.host_calls - calls
    out["records_s"] = records_s
    out["seconds"] = time.perf_counter() - t0
    if ctx.device_type == "gpu":
        out["nvidia_smi"] = nvidia_smi()
    losses = out["epoch_losses"]
    bad = []
    if params is not None and out["params"] != params:
        bad.append("%d parameters, want %d" % (out["params"], params))
    if not out["finite"]:
        bad.append("a parameter is not finite")
    if not all(losses[-1][k] < losses[0][k]
               for k in ("CrossEntropy", "SmoothL1")):
        bad.append("the losses did not fall")
    if any(counts.values()) or any(by_source.values()):
        bad.append("a kernel launched: %s %s" % (counts, by_source))
    if bad:
        raise SystemExit("ssd_train: %s: %s" % ("; ".join(bad),
                                                 json.dumps(out)))
    return out


def _ssd_step(ctx, init, batch, tf32=False):
    """One f32 SGD step of ssd_mini on ``ctx`` from ``init`` (arg, aux);
    the outputs and each parameter's and moving statistic's change."""
    x, y = batch
    mod = mx.mod.Module(ssd.get_mini_symbol_train(num_classes=3),
                        data_names=("data",), label_names=("label",),
                        context=ctx)
    mod.bind(data_shapes=[("data", x.shape)], label_shapes=[("label",
                                                              y.shape)])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in init[0].items()},
                    aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in init[1].items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": SSD_CHECK["lr"], "momentum": 0.9, "wd": 5e-4,
        "rescale_grad": 1.0 / x.shape[0], "clip_gradient": 4.0})
    with tf32_mode(tf32):
        mod.forward_backward(mx.io.DataBatch(
            data=[mx.nd.array(x, ctx=mx.cpu())],
            label=[mx.nd.array(y, ctx=mx.cpu())]))
        mod.update()
    outs = [o.asnumpy() for o in mod.get_outputs()]
    arg, aux = mod.get_params()
    delta = {k: torch.from_numpy(v.asnumpy() - init[0][k])
             for k, v in arg.items()}
    delta.update({k: torch.from_numpy(v.asnumpy() - init[1][k])
                  for k, v in aux.items()})
    return outs, delta


def ssd_check_phase(ctx, workdir, cfg=SSD_CHECK, check_ctx=None):
    """(a) One f32 SGD step of ``ssd_mini`` at ``cfg``'s size on ``ctx``
    and on ``check_ctx`` (default: the CPU) from the same parameters (the
    port's Xavier from a seed) and batch: the image a normal draw (the
    made images' flat rectangles leave max-pool windows of values within
    rounding of each other, where rounding routes the gradient), the
    labels the made records'.  The class targets equal, and each
    parameter's change within TOL_SSD_CHECK of the CPU's, a convolution's
    bias ahead of a BatchNorm (true gradient 0) within TOL_SSD_CHECK_LR of
    lr; on the card the step with TF32 in cuBLAS and cuDNN, run as a
    control, must miss the bound.  (b) ``ssd_mini`` trained on ``ctx``
    through ``train_net`` as ``tests/test_ssd_e2e.py`` trains it, scored by
    ``evaluate_net``: the VOC07 mAP above TOL_SSD_MAP."""
    check_ctx = check_ctx or mx.cpu()
    t0 = time.perf_counter()
    size, batch = cfg["data_shape"], cfg["batch_size"]
    rec = os.path.join(workdir, "ssd_check.rec")
    ssd.make_record_file(rec, cfg["images"], size, seed=0)
    it = mx.image_det.DetRecordIter(rec, batch, (3, size, size),
                                    mean_pixels=(128, 128, 128))
    label = next(iter(it)).label[0].asnumpy()
    x = np.random.RandomState(1).normal(0, 50, (batch, 3, size, size)) \
        .astype(np.float32)
    probe = mx.mod.Module(ssd.get_mini_symbol_train(num_classes=3),
                          data_names=("data",), label_names=("label",),
                          context=mx.cpu())
    probe.bind(data_shapes=[("data", x.shape)],
               label_shapes=[("label", label.shape)])
    probe.init_params(initializer=mx.init.Xavier(
        rnd_type="gaussian", factor_type="out", magnitude=2, rng=0))
    init = tuple({k: v.asnumpy().copy() for k, v in d.items()}
                 for d in probe.get_params())
    outs, delta = _ssd_step(ctx, init, (x, label))
    ref_outs, ref_delta = _ssd_step(check_ctx, init, (x, label))
    ahead_of_bn = {k for k in init[0]
                   if k.startswith("convm") and k.endswith("_bias")}

    def readings(d):
        held = update_diff({k: v for k, v in d.items()
                            if k not in ahead_of_bn},
                           {k: v for k, v in ref_delta.items()
                            if k not in ahead_of_bn and v.norm() > 0})
        held["bias_ahead_of_bn_in_lr"] = max(
            float((d[k] - ref_delta[k]).abs().max()) / SSD_CHECK["lr"]
            for k in ahead_of_bn)
        return held

    step = dict(readings(delta), cls_target_equal=bool(
        np.array_equal(outs[2], ref_outs[2])),
        cls_prob_max_abs=float(np.abs(outs[0] - ref_outs[0]).max()),
        loc_loss_max_abs=float(np.abs(outs[1] - ref_outs[1]).max()))
    control = None
    if ctx.device_type == "gpu":
        _o, t_delta = _ssd_step(ctx, init, (x, label), tf32=True)
        control = readings(t_delta)

    args = ssd.parse_args([])
    mod = ssd.train_net(rec, network="mini", num_classes=3,
                        batch_size=batch, data_shape=(3, size, size),
                        num_epochs=cfg["epochs"], lr=cfg["lr"], ctx=ctx,
                        seed=args.seed, rand_mirror=False,
                        mean_pixels=(128, 128, 128), frequent=10000)
    res = dict(ssd.evaluate_net(mod, rec, 3, network="mini",
                                batch_size=batch,
                                data_shape=(3, size, size), ctx=ctx,
                                class_names=list(ssd.CLASS_NAMES),
                                mean_pixels=(128, 128, 128)))
    out = {"config": cfg, "contexts": [str(ctx), str(check_ctx)],
           "step": step, "tol": TOL_SSD_CHECK, "tol_lr": TOL_SSD_CHECK_LR,
           "control_tf32": control, "mAP": res["mAP"], "aps": res,
           "tol_map": TOL_SSD_MAP, "seconds": time.perf_counter() - t0}

    def within(r):
        return r["max_rel_update_diff"] <= TOL_SSD_CHECK \
            and r["bias_ahead_of_bn_in_lr"] <= TOL_SSD_CHECK_LR

    bad = []
    if not within(step) or not step["cls_target_equal"]:
        bad.append("the step differs from the CPU's")
    if control is not None and within(control):
        bad.append("the TF32 control passes the bound")
    if ctx.device_type == "gpu" and not res["mAP"] > TOL_SSD_MAP:
        bad.append("mAP %.4f" % res["mAP"])
    if bad:
        raise SystemExit("ssd_check: %s: %s" % ("; ".join(bad),
                                                 json.dumps(out)))
    return out


def rcnn_train_phase(ctx, cfg=RCNN_FULL):
    """``tools/rcnn.py`` (Proposal, the proposal_target Custom op,
    ROIPooling, Module.fit) for ``cfg``'s epochs on ``ctx``, then
    ``evaluate``; the kernel counts set to 0 just before and read just
    after (no kernel lies on this path).  Checks: every parameter finite,
    the RPN's and the head's log losses of the last ten steps below the
    first ten's, one Custom host round trip a step, an mAP in [0, 1],
    every count 0."""
    args = rcnn.parse_args(["--epochs", str(cfg["epochs"]), "--images",
                            str(cfg["images"]), "--test-images",
                            str(cfg["test_images"])])
    t0 = time.perf_counter()
    zero_kernel_counts()
    out, _mod = rcnn.run(args, ctx)
    out["kernel_launches"] = counts = kernel_counts()
    out["flash_source_launches"] = by_source = flash_source_counts()
    out["seconds"] = time.perf_counter() - t0
    if ctx.device_type == "gpu":
        out["nvidia_smi"] = nvidia_smi()
    first, last = out["first_losses"], out["last_losses"]
    bad = []
    if not out["finite"]:
        bad.append("a parameter is not finite")
    if not (last[0] < first[0] and last[2] < first[2]):
        bad.append("the log losses did not fall")
    if out["custom_round_trips_per_step"] != 1.0:
        bad.append("Custom round trips a step")
    if not 0.0 <= out["mAP"] <= 1.0:
        bad.append("mAP %r" % out["mAP"])
    if any(counts.values()) or any(by_source.values()):
        bad.append("a kernel launched: %s %s" % (counts, by_source))
    if bad:
        raise SystemExit("rcnn_train: %s: %s" % ("; ".join(bad),
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
        matmul_stats.launches = 0
        with tf32_mode(tf32):
            loss = float(trainer.step(staged))
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
#: the validation accuracy after the fit, its moving statistics
#: re-estimated at the final weights, must exceed this: a one-class guess
#: scores 0.25.  The fit's own validation (moving statistics as trained)
#: is not gated: after 64 steps at lr 0.1 they still lag the weights, and
#: on an NVIDIA H100 80GB HBM3 at 700.00 W it read from 0.4746 to 1.0
#: after the second epoch, where each batch's own statistics and the
#: re-estimated ones read 1.0 in 16 of 16 fits
#: (``tools.imagenet_val_probe``)
TOL_VAL_ACCURACY = 0.75
#: train batches that re-estimate the moving statistics (one epoch's
#: worth; the momentum of 0.9 leaves 0.9**32 = 0.03 of the trained ones)
IMAGENET_REESTIMATE_BATCHES = 32
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
    ``k5_blocks`` on K5.  Then the moving statistics re-estimated at the
    final weights from ``IMAGENET_REESTIMATE_BATCHES`` train batches (no
    weight update) and the validation accuracy through ``trainer.forward``
    above ``tol_accuracy``; the fit's own last validation is reported
    beside it.  Then ``io_train_bench.train_loop`` sequential and
    prefetched on the fit's trainer (end-to-end images/s, per-stage
    walls; prefetched again with 2 decode threads, where the others take
    the host's cores), and the queue against inline staging to the bit."""
    from mxnet_tpu_torch import kvstore
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.tools import fit, train_imagenet
    from mxnet_tpu_torch.tools.imagenet_val_probe import (
        accuracy, reestimate_moving_stats)
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
    zero_kernel_counts()
    t0 = time.perf_counter()
    trainer = fit.fit(args, net, train_imagenet.get_rec_iter,
                      history=history)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
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
    train_it, val_it = train_imagenet.get_rec_iter(
        args, kvstore.create(args.kv_store))
    reestimation = reestimate_moving_stats(trainer, train_it,
                                           IMAGENET_REESTIMATE_BATCHES)
    val_accuracy = accuracy(trainer, val_it)
    for it in (train_it, val_it):
        if hasattr(it, "close"):
            it.close()
    if not val_accuracy > tol_accuracy:
        raise SystemExit("imagenet_train: validation accuracy %s after the "
                         "moving statistics were re-estimated (the fit's "
                         "own: %s), bound %s"
                         % (val_accuracy, history["epochs"][-1]["val"],
                            tol_accuracy))
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
           "val_reestimated": val_accuracy, "reestimation": reestimation,
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
    zero_kernel_counts()
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
    counts = kernel_counts()
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


# ------------------------------------------------------- the resume drill
#: the preemption drill (tools.resume_train): the uninterrupted run's
#: steps, and the step after which the parent sends the preempted child
#: SIGTERM; landing between steps, the signal is served at once, so the
#: checkpoint the resumed child loads is the state after that step.  The
#: three runs take cuDNN's deterministic algorithms, K5 reduces in a fixed
#: order and R starts from P's state read back to the bit, so R's losses
#: are held equal to U's, exactly
RESUME_STEPS = 10
RESUME_SIGNAL_AFTER = 4
#: epochs of the CLI round trip (tools.train_imagenet --fused 1
#: --model-prefix, then --load-epoch 1) on the validation records
RESUME_CLI_EPOCHS = 2


def _drill_child(argv, workdir, name, send_signal=False, timeout=600,
                 env=None):
    """``tools.resume_train`` in a child process: ``(exit code, its JSON
    lines, wall seconds, the tail of its stderr)``; with ``send_signal``
    SIGTERM goes to it when it reports waiting for one; ``env`` adds
    environment variables.  The child computes with this process's number
    of torch threads (on the CPU their count sets the order of a sum, and
    the drill compares the runs to the bit).  The child is killed if it
    outlives ``timeout``."""
    err_path = os.path.join(workdir, name + ".err")
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.resume_train"] + argv
    t0 = time.perf_counter()
    lines = []
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=err, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()),
                     **(env or {})))
        timer = threading.Timer(timeout, proc.kill)
        timer.start()
        try:
            for line in proc.stdout:
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                lines.append(rec)
                if send_signal and rec.get("waiting_for_signal"):
                    proc.send_signal(signal.SIGTERM)
            rc = proc.wait()
        finally:
            timer.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(err_path) as f:
        tail = f.read()[-2000:]
    return rc, lines, time.perf_counter() - t0, tail


def _preemption_dump(directory, step):
    """The flight dump run P left under ``directory``: one
    ``mxtpu-flight/1`` file of reason ``sigterm`` whose events hold the
    ``preemption`` event and the ``step_begin`` of step ``step`` (the
    step the signal followed); else SystemExit."""
    names = sorted(n for n in os.listdir(directory)
                   if n.startswith("flight-") and n.endswith(".json")) \
        if os.path.isdir(directory) else []
    if len(names) != 1:
        raise SystemExit("resume_train: run P left flight dumps %s in %s; "
                         "want one" % (names, directory))
    with open(os.path.join(directory, names[0])) as f:
        doc = json.load(f)
    kinds = [e["kind"] for e in doc["events"]]
    begun = [e for e in doc["events"] if e["kind"] == "step_begin"
             and e.get("step") == step]
    ok = (doc.get("schema") == "mxtpu-flight/1"
          and doc.get("reason") == "sigterm" and "preemption" in kinds
          and len(begun) == 1)
    out = {"file": names[0], "reason": doc.get("reason"),
           "events": len(kinds), "preemption": "preemption" in kinds,
           "step_begin_of_step": step, "step_begin_found": len(begun),
           "live_memory": doc.get("live_memory")}
    if not ok:
        raise SystemExit("resume_train: run P's flight dump %s" % out)
    return out


def _same_batches(got, want):
    """Whether two runs' step records hold the same labels and pixels."""
    return len(got) == len(want) and all(
        g["labels"] == w["labels"] and g["pixels_crc32"] == w["pixels_crc32"]
        for g, w in zip(got, want))


def resume_train_phase(ctx, recs, workdir, steps=RESUME_STEPS,
                       signal_after=RESUME_SIGNAL_AFTER, layers=50,
                       image=224, batch=128, dtype="bfloat16", k5_blocks=16):
    """The preemption drill of ``tools.resume_train`` on the train records:
    run U (uninterrupted, ``steps`` steps of the full-width ResNet-``layers``
    in bf16 NHWC with block fusion, one decode thread, in this process), run
    P (a child with ``install_preemption_handler``, sent SIGTERM after step
    ``signal_after``: it must checkpoint that step's state at once and
    exit 0, and its manifest must verify) and run R (a fresh child:
    ``load_latest_checkpoint(load_optimizer_states=True)``,
    ``restore_data_iter``, the remaining steps).  P's batches must equal
    U's, and the state P saved U's after the same step (CRC32 of every
    array against the manifest); R's batches must equal U's after the
    checkpoint (labels and the CRC32 of the uint8 pixels), every array R
    loaded the one P saved, and R's losses U's, all exactly; K5 must
    launch ``k5_blocks`` times a step in U and in R, every other kernel 0
    times.  The control: the iterator restored with the data state dropped
    (offset 0) must fail the batch check.  Then the checkpoint's size, U's
    save and load walls of it in this process and R's load wall in its own,
    and the CLI round trip: ``tools.train_imagenet --fused 1
    --model-prefix`` for one epoch of the validation records, then
    ``--load-epoch 1`` for a second; each epoch's checkpoint must verify."""
    from mxnet_tpu_torch import resilience
    from mxnet_tpu_torch.tools import resume_train, train_imagenet
    on_card = ctx.device_type == "gpu"
    prefix = os.path.join(workdir, "drill", "resnet")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    base = ["--data-train", recs["train"], "--prefix", prefix, "--steps",
            str(steps), "--num-layers", str(layers), "--image", str(image),
            "--batch-size", str(batch), "--dtype", dtype] \
        + ([] if on_card else ["--cpu", "1"])
    saved = signal_after
    deterministic = torch.backends.cudnn.deterministic
    try:
        t0 = time.perf_counter()
        u = resume_train.drill(resume_train.parser().parse_args(
            base + ["--mode", "uninterrupted", "--state-after", str(saved)]),
            ctx, out=None, keep_trainer=True)
        u_wall = time.perf_counter() - t0
        trainer = u.pop("trainer")
        # the checkpoint's save and load walls, here, on U's trainer
        walls_prefix = os.path.join(workdir, "walls", "resnet")
        os.makedirs(os.path.dirname(walls_prefix), exist_ok=True)
        t0 = time.perf_counter()
        trainer.save_checkpoint(walls_prefix, steps,
                                save_optimizer_states=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        trainer.load_checkpoint(walls_prefix, steps,
                                load_optimizer_states=True)
        if on_card:
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    u_steps = u["steps"]
    want = k5_blocks * steps if on_card else 0
    if u["launches"]["matmul_stats"] != want or any(
            v for k, v in u["launches"].items() if k != "matmul_stats"):
        raise SystemExit("resume_train: run U launched %s over %d steps; "
                         "want matmul_stats %d, the rest 0"
                         % (u["launches"], steps, want))

    flight_dir = os.path.join(workdir, "flight")
    p_rc, p_lines, p_wall, p_err = _drill_child(
        base + ["--mode", "preempted", "--signal-after", str(signal_after)],
        workdir, "preempted", send_signal=True,
        env={"MXNET_TPU_FLIGHT_DIR": flight_dir})
    if p_rc != 0:
        raise SystemExit("resume_train: run P exited %d: %s" % (p_rc, p_err))
    flight = _preemption_dump(flight_dir, signal_after)
    epoch = mx.model.find_latest_checkpoint(prefix, require_states=True)
    manifest = resilience.verify_manifest(prefix, epoch) \
        if epoch is not None else None
    if epoch != saved or manifest is None:
        raise SystemExit("resume_train: run P's checkpoint is epoch %s, "
                         "want %d (signal after step %d)"
                         % (epoch, saved, signal_after))
    p_steps = [r for r in p_lines if "step" in r and "loss" in r]
    data_state = manifest["meta"]["data_state"]["state"]
    size = {k: v["size"] for k, v in manifest["files"].items()}

    r_rc, r_lines, r_wall, r_err = _drill_child(
        base + ["--mode", "resumed"], workdir, "resumed")
    if r_rc != 0:
        raise SystemExit("resume_train: run R exited %d: %s" % (r_rc, r_err))
    r = r_lines[-1]
    r_steps = [x for x in r_lines if "step" in x and "loss" in x]
    tail = u_steps[saved:]
    batches_equal = _same_batches(r_steps, tail)
    want_r = k5_blocks * len(tail) if on_card else 0
    out = {"network": "resnet%d" % layers, "batch": batch, "image": image,
           "dtype": dtype, "layout": "NHWC", "fuse_blocks": True,
           "decode_threads": 1, "steps": steps,
           "signal_after_step": signal_after, "checkpoint_epoch": epoch,
           "data_state": data_state, "applied_state": r["applied_state"],
           "flight_dump": flight,
           "step_s_u": [x["step_s"] for x in u_steps],
           "step_s_r": [x["step_s"] for x in r_steps],
           "losses_u": [x["loss"] for x in u_steps],
           "losses_p": [x["loss"] for x in p_steps],
           "losses_r": [x["loss"] for x in r_steps],
           "losses_equal": [x["loss"] for x in r_steps]
           == [x["loss"] for x in tail],
           "batches_equal": batches_equal,
           "p_batches_equal_u": _same_batches(p_steps,
                                              u_steps[:len(p_steps)]),
           "loaded_equal_saved": r["loaded_equal_saved"],
           "arrays": r["arrays"],
           "u_state_equals_p_saved": u["state_crcs"] == {
               k: v["crc32"] for k, v in manifest["arrays"].items()},
           "launches_u": u["launches"], "launches_r": r["launches"],
           "k5_per_step_u": u["launches"]["matmul_stats"] / steps,
           "k5_per_step_r": r["launches"]["matmul_stats"]
           / max(1, len(r_steps)),
           "checkpoint_bytes": size,
           "checkpoint_total_bytes": sum(size.values()),
           "save_s": save_s, "load_s": load_s, "r_load_s": r["load_s"],
           "u_wall_s": u_wall, "p_wall_s": p_wall, "r_wall_s": r_wall,
           "r_build_s": r["build_s"],
           # the child's start (interpreter, imports, CUDA) before the drill
           "r_startup_s": r_wall - r["drill_s"],
           "r_to_first_step_s": r_wall - r["drill_s"]
           + (r_steps[0]["t_s"] if r_steps else 0.0)}
    if not out["p_batches_equal_u"] or len(p_steps) != signal_after:
        raise SystemExit("resume_train: run P's batches differ from run "
                         "U's: %s" % json.dumps(out))
    if not out["u_state_equals_p_saved"]:
        raise SystemExit("resume_train: the state P saved differs from "
                         "U's after step %d: %s" % (saved, json.dumps(out)))
    if not batches_equal or [x["step"] for x in r_steps] != list(
            range(saved + 1, steps + 1)):
        raise SystemExit("resume_train: run R's batches differ from run "
                         "U's after step %d: %s" % (saved, json.dumps(out)))
    if not r["loaded_equal_saved"]:
        raise SystemExit("resume_train: the state R loaded differs from "
                         "the one P saved: %s" % json.dumps(out))
    if not out["losses_equal"]:
        raise SystemExit("resume_train: R's losses differ from U's: %s"
                         % json.dumps(out))
    if r["launches"]["matmul_stats"] != want_r or any(
            v for k, v in r["launches"].items() if k != "matmul_stats"):
        raise SystemExit("resume_train: run R launched %s over %d steps; "
                         "want matmul_stats %d, the rest 0"
                         % (r["launches"], len(tail), want_r))
    # the control: the same restore with the data state dropped
    args = resume_train.parser().parse_args(base)
    it = resume_train.records_iter(args)
    it.restore(dict(data_state, offset=0))
    dropped = []
    for _ in range(len(tail)):
        b = next(it)
        dropped.append(resume_train.batch_record(
            {"data": b.data[0].data, "softmax_label": b.label[0].data}))
    it.close()
    out["control_dropped_state_batches_equal"] = _same_batches(dropped, tail)
    if out["control_dropped_state_batches_equal"]:
        raise SystemExit("resume_train: the control with the data state "
                         "dropped passed the batch check")

    # the CLI round trip, in this process
    cli_prefix = os.path.join(workdir, "cli", "resnet")
    os.makedirs(os.path.dirname(cli_prefix), exist_ok=True)
    argv = ["--network", "resnet", "--num-layers", str(layers),
            "--data-train", recs["val"], "--image-shape",
            "3,%d,%d" % (image, image), "--num-classes", "1000",
            "--data-nthreads", str(os.cpu_count() or 1), "--batch-size",
            str(batch), "--dtype", dtype, "--fused", "1", "--lr", "0.1",
            "--disp-batches", "0", "--model-prefix", cli_prefix] \
        + ([] if on_card else ["--cpu", "1"])
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    zero_kernel_counts()
    t0 = time.perf_counter()
    try:       # main() sets up logging at INFO for its process
        first = train_imagenet.main(argv + ["--num-epochs", "1"])
        second = train_imagenet.main(argv + ["--num-epochs",
                                             str(RESUME_CLI_EPOCHS),
                                             "--load-epoch", "1"])
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)
    cli_wall = time.perf_counter() - t0
    cli_counts = kernel_counts()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verified = {}
    for ep in range(1, RESUME_CLI_EPOCHS + 1):
        doc = resilience.verify_manifest(cli_prefix, ep)
        verified[ep] = doc is not None and sorted(doc["files"]) == [
            "resnet-%04d.params" % ep, "resnet-%04d.states" % ep]
    cli_steps = len(first["losses"]) + len(second["losses"])
    out["cli"] = {
        "epochs_first": [e["epoch"] for e in first["epochs"]],
        "epochs_second": [e["epoch"] for e in second["epochs"]],
        "losses": first["losses"] + second["losses"],
        "checkpoints": [e.get("checkpoint") for e in
                        first["epochs"] + second["epochs"]],
        "verified": verified, "steps": cli_steps, "launches": cli_counts,
        "wall_s": cli_wall}
    if not all(verified.values()) or out["cli"]["epochs_second"] != list(
            range(1, RESUME_CLI_EPOCHS)) or not np.isfinite(
            out["cli"]["losses"]).all():
        raise SystemExit("resume_train: the CLI round trip: %s"
                         % json.dumps(out["cli"]))
    if cli_counts["matmul_stats"] != (k5_blocks * cli_steps if on_card
                                      else 0):
        raise SystemExit("resume_train: the CLI round trip launched %s over "
                         "%d steps" % (cli_counts, cli_steps))
    out["kernel_launches"] = {
        k: u["launches"][k] + r["launches"][k] + cli_counts[k]
        for k in cli_counts}
    out["nvidia_smi"] = nvidia_smi() if on_card else None
    return out


# ------------------------------------------------------------- telemetry
#: telemetry_train: steps a run, the steps the device trace covers, K5's
#: kernel as the device trace names it, and the verdicts ioview may give
TELEMETRY_STEPS = 8
TELEMETRY_PROFILED = (5, 6)
K5_KERNEL_NAME = "matmul_stats_sm90_kernel"
IOVIEW_VERDICTS = ("producer-bound", "consumer-bound", "balanced")


class _FirstBatches:
    """The first ``n`` batches of ``it``, then the epoch's end: a fit that
    takes exactly ``n`` steps, whose iterator is never asked for more."""

    def __init__(self, it, n):
        self._it, self._n, self._taken = it, n, 0
        self.provide_data = it.provide_data
        self.provide_label = it.provide_label
        self.batch_size = it.batch_size

    def __getattr__(self, name):        # device_normalization, close, ...
        return getattr(self._it, name)

    def __iter__(self):
        return self

    def __next__(self):
        if self._taken >= self._n:
            raise StopIteration
        self._taken += 1
        return self._it.next()

    next = __next__

    def reset(self):
        self._taken = 0
        self._it.reset()


def _telemetry_run(ctx, args, steps, workdir, sinks, profiled):
    """One fit of ``steps`` batches through ``tools.fit`` with the
    telemetry sinks on or off; returns the losses, the launches, the host
    syncs inside each step and in all, the memory statistics each step
    end read, and the host wall of each step."""
    from mxnet_tpu_torch import profiler, telemetry
    from mxnet_tpu_torch.tools import fit, train_imagenet
    on_card = ctx.device_type == "gpu"
    from mxnet_tpu_torch.telemetry import costdb
    names = ("MXNET_TPU_TELEMETRY_JSONL", "MXNET_TPU_FLIGHT_DIR",
             "MXNET_TPU_IOVIEW_EVERY", "MXNET_PROFILER_XLA_DIR",
             "MXNET_TPU_COSTDB_SAMPLE")
    saved_env = {k: os.environ.get(k) for k in names}
    os.makedirs(workdir, exist_ok=True)
    files = {"jsonl": os.path.join(workdir, "steps.jsonl"),
             "flight": os.path.join(workdir, "flight"),
             "profile": os.path.join(workdir, "profile.json"),
             "device": os.path.join(workdir, "device")}
    for k in names:
        os.environ.pop(k, None)
    os.environ.update(
        {"MXNET_TPU_TELEMETRY_JSONL": files["jsonl"],
         "MXNET_TPU_FLIGHT_DIR": files["flight"],
         "MXNET_TPU_IOVIEW_EVERY": "1",
         "MXNET_PROFILER_XLA_DIR": files["device"],
         "MXNET_TPU_COSTDB_SAMPLE": "1"} if sinks else
        {"MXNET_TPU_IOVIEW_EVERY": "0", "MXNET_TPU_COSTDB_SAMPLE": "0"})
    telemetry.reset()
    # events left by an earlier profiler session go to a file of their own
    profiler.profiler_set_config(
        mode="all", filename=os.path.join(workdir, "earlier.json"))
    profiler.dump_profile()
    profiler.profiler_set_config(mode="all", filename=files["profile"])
    traces_before = len(profiler.device_traces())
    stats_reads = []
    real_stats = torch.cuda.memory_stats

    def memory_stats(*a, **kw):         # what the step-end sample read
        out = real_stats(*a, **kw)
        stats_reads.append(dict(out))
        return out

    rec = {"syncs": [], "mem": [], "step_s": [], "profiler_syncs": 0}
    real_step = ShardedTrainer.step

    def step(self, batch):
        n = len(rec["step_s"]) + 1
        if sinks and n == profiled[0]:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                profiler.profiler_set_state("run")
            rec["profiler_syncs"] += len(w)
        seen = len(stats_reads)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            loss = real_step(self, batch)
            rec["step_s"].append(time.perf_counter() - t0)
        rec["syncs"].append(sum("synchroniz" in str(x.message) for x in w))
        rec["mem"].append(stats_reads[-1] if len(stats_reads) > seen
                          else None)
        if sinks and n == profiled[1]:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                profiler.profiler_set_state("stop")
            rec["profiler_syncs"] += len(w)
        return loss

    def loader(a, kv):
        train, _val = train_imagenet.get_rec_iter(a, kv)
        return _FirstBatches(train, steps), None

    history = {}
    np.random.seed(0)                   # the initializer's draws
    random.seed(0)
    ShardedTrainer.step = step
    if on_card:
        torch.cuda.memory_stats = memory_stats
        torch.cuda.set_sync_debug_mode("warn")
    zero_kernel_counts()
    try:
        with warnings.catch_warnings(record=True) as w_all:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            fit.fit(args, _imagenet_net(args), loader, history=history)
            wall = time.perf_counter() - t0
    finally:
        ShardedTrainer.step = real_step
        torch.cuda.memory_stats = real_stats
        if on_card:
            torch.cuda.set_sync_debug_mode(0)
        if profiler.is_running():
            profiler.profiler_set_state("stop")
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    counts = kernel_counts()
    syncs_all = sum("synchroniz" in str(x.message) for x in w_all)
    out = {"losses": history["losses"], "launches": counts,
           "syncs_per_step": rec["syncs"], "step_s": rec["step_s"],
           "syncs_in_fit": syncs_all - rec["profiler_syncs"],
           "profiler_syncs": rec["profiler_syncs"], "mem": rec["mem"],
           "fit_s": wall, "io": history["io"],
           "ioview": telemetry.ioview.snapshot(),
           "report": telemetry.report(), "files": files,
           "costdb": costdb.summary()["by_kind"]}
    if sinks:
        profiler.dump_profile()
        out["device_traces"] = profiler.device_traces()[traces_before:]
    return out


def _imagenet_net(args):
    from mxnet_tpu_torch.models import get_model
    return get_model(args.network, num_classes=args.num_classes,
                     num_layers=args.num_layers,
                     image_shape=args.image_shape)


def _check_jsonl(path, steps, batch, mem, on_card):
    """Gate 3: one line a step, each with its step time, the trainer.step
    and data.fetch span totals, the compute/input_wait segments, the
    memory gauges equal to the statistics the step's end read, and the
    ioview record."""
    with open(path) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    bad = []
    if [r.get("step") for r in lines] != list(range(1, steps + 1)):
        bad.append("steps %s" % [r.get("step") for r in lines])
    for r, m in zip(lines, mem):
        spans, seg = r.get("spans", {}), r.get("segments", {})
        ok = (isinstance(r.get("step_time_s"), float)
              and r.get("samples") == batch
              and {"trainer.step", "data.fetch"} <= set(spans)
              and {"compute", "input_wait"} <= set(seg)
              and isinstance(r.get("io"), dict))
        if on_card:
            g = r.get("gauges", {})
            ok = ok and m is not None and (
                g.get('mxtpu_hbm_bytes_in_use{device="cuda:0"}')
                == m["allocated_bytes.all.current"]) and (
                g.get('mxtpu_hbm_peak_bytes{device="cuda:0"}')
                == m["allocated_bytes.all.peak"])
        if not ok:
            bad.append(r.get("step"))
    if bad:
        raise SystemExit("telemetry_train: JSONL lines fail gate 3: %s"
                         % bad)
    return lines


def _check_profile(path, profiled):
    """Gate 5: the Chrome trace parses; its operator events and its spans
    share the profiler's clock (every operator event lies inside one of the
    ``len(profiled)`` trainer.step spans)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e["name"] == "trainer.step"]
    ops = [e for e in events if e["cat"] == "operator"]
    spans = [e for e in events if e["cat"] != "operator"]
    outside = [e["name"] for e in ops if not any(
        s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]
        for s in steps)]
    out = {"events": len(events), "operator_events": len(ops),
           "span_events": len(spans), "trainer_step_spans": len(steps),
           "span_names": sorted({e["name"] for e in spans}),
           "operator_events_outside_steps": len(outside)}
    if len(steps) != len(profiled) or not ops or outside \
            or "data.fetch" not in out["span_names"]:
        raise SystemExit("telemetry_train: Chrome trace fails gate 5: %s"
                         % out)
    return out


def _device_kernels(path, name):
    """Gate 6's count: the device trace's kernel events naming ``name``."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return len(kernels), sum(name in e.get("name", "") for e in kernels)


def telemetry_train_phase(ctx, recs, workdir, steps=TELEMETRY_STEPS,
                          profiled=TELEMETRY_PROFILED, layers=50, image=224,
                          batch=128, dtype="bfloat16", k5_blocks=16):
    """``tools.train_imagenet``'s fused route on the train records (the
    first ``steps`` batches): ResNet-``layers`` v2, ``batch``, ``image``,
    ``dtype``, NHWC, block fusion, one decode thread, cuDNN deterministic,
    a ``DevicePrefetchIter`` of depth 2.  Two runs in this process: every
    telemetry sink off, then the JSONL step log, the flight directory,
    ioview every step and the profiler (mode all, with its device trace
    over steps ``profiled``).  The gates: (1) the losses equal to the bit
    and K5 ``k5_blocks`` launches a step in both (0 on the CPU); (2) the
    host syncs inside each step equal, counted under
    ``set_sync_debug_mode("warn")`` (those outside the steps, the
    profiler's own start and stop apart, are reported); (3) the JSONL
    (:func:`_check_jsonl`); (4) ioview's ``decode`` and
    ``batch`` items ``batch`` a batch fetched, ``device_stage`` one a
    batch, the verdict one of the JAX names; (5) the Chrome trace
    (:func:`_check_profile`); (6) the device trace names K5's kernel
    ``k5_blocks`` times a profiled step; (7) ``tools.bench --dry-run``'s
    line with a telemetry block of 5 steps.  The step time with telemetry
    on and off is printed, not gated (the host's speed varies between
    calls)."""
    from mxnet_tpu_torch.tools import bench
    on_card = ctx.device_type == "gpu"
    args = _imagenet_args(
        recs["train"], ctx, layers, image, "--batch-size", str(batch),
        "--dtype", dtype, "--fused", "1", "--num-epochs", "1",
        "--lr", "0.01", "--mom", "0.9", "--wd", "1e-4",
        "--device-queue", "1", "--data-nthreads", "1", "--disp-batches",
        "0")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [_telemetry_run(ctx, args, steps,
                               os.path.join(workdir, "telemetry_" + tag),
                               sinks, profiled)
                for tag, sinks in (("off", False), ("on", True))]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    off, on = runs
    want = k5_blocks * steps if on_card else 0
    for tag, r in zip(("off", "on"), runs):
        c = r["launches"]
        if c["matmul_stats"] - c["matmul_stats_f32"] != want or any(
                v for k, v in c.items() if k != "matmul_stats"):
            raise SystemExit("telemetry_train: run %s launched %s; want "
                             "matmul_stats %d, the rest 0" % (tag, c, want))
    if off["losses"] != on["losses"] or len(on["losses"]) != steps:
        raise SystemExit("telemetry_train: losses differ: off %s, on %s"
                         % (off["losses"], on["losses"]))
    if off["syncs_per_step"] != on["syncs_per_step"]:
        raise SystemExit("telemetry_train: host syncs differ: off %s, on %s"
                         % (off["syncs_per_step"], on["syncs_per_step"]))
    # the sinks-on run sampled the cost database at every step after the
    # first; the sinks-off run at none
    if not on["costdb"].get("program") or off["costdb"]:
        raise SystemExit("telemetry_train: costdb records off %s, on %s"
                         % (off["costdb"], on["costdb"]))
    lines = _check_jsonl(on["files"]["jsonl"], steps, batch, on["mem"],
                         on_card)
    stages = on["ioview"]["stages"]
    items = {k: stages.get(k, {}).get("items") for k in
             ("decode", "batch", "device_stage")}
    verdict = on["io"]["bottleneck"]
    if items != {"decode": batch * steps, "batch": batch * steps,
                 "device_stage": steps} \
            or (verdict or {}).get("verdict") not in IOVIEW_VERDICTS:
        raise SystemExit("telemetry_train: ioview items %s, verdict %s"
                         % (items, verdict))
    profile = _check_profile(on["files"]["profile"], profiled)
    if len(on["device_traces"]) != 1:
        raise SystemExit("telemetry_train: device traces %s"
                         % on["device_traces"])
    kernels, k5 = _device_kernels(on["device_traces"][0], K5_KERNEL_NAME)
    want_k5 = k5_blocks * len(profiled) if on_card else 0
    if k5 != want_k5:
        raise SystemExit("telemetry_train: the device trace names %s %d "
                         "times over %d steps; want %d"
                         % (K5_KERNEL_NAME, k5, len(profiled), want_k5))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.dry_run(ctx)
    dry = json.loads(buf.getvalue().strip().splitlines()[-1])
    if dry.get("telemetry", {}).get("steps") != 5 or "io" not in dry:
        raise SystemExit("telemetry_train: bench --dry-run printed %s" % dry)

    def per_step(key, name):
        return float(np.mean([r[key].get(name, {}).get("total_s", 0.0)
                              if key == "spans" else r[key][name]
                              for r in lines]))

    launches = on["launches"]
    return {
        "network": "resnet%d" % layers, "batch": batch, "image": image,
        "dtype": dtype, "layout": "NHWC", "fuse_blocks": True,
        "decode_threads": 1, "steps": steps, "profiled_steps": profiled,
        "losses": on["losses"], "losses_equal": True,
        "syncs_per_step": on["syncs_per_step"],
        "costdb_records_on": on["costdb"],
        # the rest of the fit's syncs (the masters' upload, the epoch's
        # end, the worker's first staging) are counted by warnings that
        # Python's catch_warnings gathers across threads without a lock:
        # reported, not gated
        "syncs_outside_steps": {"off": off["syncs_in_fit"],
                                "on": on["syncs_in_fit"]},
        "profiler_syncs": on["profiler_syncs"],
        "step_ms_off": [1e3 * x for x in off["step_s"]],
        "step_ms_on": [1e3 * x for x in on["step_s"]],
        "median_step_ms_off": 1e3 * float(np.median(off["step_s"])),
        "median_step_ms_on": 1e3 * float(np.median(on["step_s"])),
        "segments_ms_per_step": {
            k: 1e3 * per_step("segments", k)
            for k in ("compute", "input_wait", "collective_wait")},
        "spans_ms_per_step": {
            k: 1e3 * per_step("spans", k)
            for k in ("trainer.step", "data.fetch")},
        "ioview": {"items": items, "verdict": verdict,
                   "stages_ms_per_batch": {
                       k: 1e3 * v["s"] / steps for k, v in stages.items()},
                   "stall_s": on["ioview"]["stall_s"],
                   "starved_s": on["ioview"]["starved_s"]},
        "chrome_trace": profile,
        "device_trace": {"kernel_events": kernels, "k5_events": k5,
                         "k5_name": K5_KERNEL_NAME,
                         "bytes": os.path.getsize(on["device_traces"][0])},
        "report_phases": on["report"]["phases"],
        "compile": on["report"]["compile"],
        "memory_live": on["report"]["memory"]["live"],
        "dry_run": {"value": dry["value"], "telemetry_steps":
                    dry["telemetry"]["steps"], "fusion": dry["fusion"]},
        "kernel_launches": launches,
        "kernel_launches_per_step": {k: v / steps
                                     for k, v in launches.items()},
        "fit_s": {"off": off["fit_s"], "on": on["fit_s"]},
        "nvidia_smi": nvidia_smi() if on_card else None}


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


# ------------------------------------------------------ the analysis layer
#: PR 20's eager rung-4 peak above the weights and the graphs' pool (run B,
#: NVIDIA H100 80GB HBM3, 700.00 W), before eval_graph freed each value at
#: its last reader
PR20_EAGER_PEAK_BYTES = 4283469824
PR20_GRAPH_POOL_BYTES = 4414504960
#: the over-tight budget of the ladder's gate: a thousandth of the card
TIGHT_BUDGET = "0.001"


def _memlive_drift(program, net, shapes, report_opts):
    """The static prediction and the measured total recorded for
    ``program``, their drift, and whether ``check_memory`` against the
    measured total emits MXG018 (under ``MXNET_TPU_MEMLIVE_TOL``)."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.analysis import memlive
    from mxnet_tpu_torch.analysis.verifier import Report
    static = telemetry.memory.static_prediction(program)
    measured = telemetry.memory.measured_total(program)
    out = {"program": program,
           "predicted_peak_bytes": static and static["peak_bytes"],
           "predicted_peak_node": static and static["peak_node"],
           "breakdown": static and static["breakdown"],
           "measured_bytes": measured, "tolerance":
           memlive.memlive_tolerance()}
    if static is None or measured is None:
        return out
    rep = Report()
    memlive.check_memory(net, shapes, report=rep, plan_total=measured,
                         advice=False, **report_opts)
    out["drift"] = (static["peak_bytes"] - measured) / float(measured)
    out["drift_gauge"] = telemetry.gauge(
        "mxtpu_memlive_drift_ratio").labels(program=program).get()
    out["mxg018"] = [d.rule for d in rep].count("MXG018")
    if bool(out["mxg018"]) != (abs(out["drift"]) > out["tolerance"]):
        raise SystemExit("analysis: %s drift %.4f against tolerance %.2f "
                         "but MXG018 emitted %d times"
                         % (program, out["drift"], out["tolerance"],
                            out["mxg018"]))
    if abs(out["drift_gauge"] - out["drift"]) > 1e-12:
        raise SystemExit("analysis: %s drift gauge %r, drift %r"
                         % (program, out["drift_gauge"], out["drift"]))
    return out


def _sync_warnings(fn):
    """``fn()`` under ``set_sync_debug_mode("warn")``; returns its result and
    the host syncs it made (none off the card)."""
    if not torch.cuda.is_initialized():
        return fn(), 0
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(x.message) for x in w)


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def analysis_phase(ctx, cfg=FULL, serve_memory=None, batch=128, image=224,
                   dtype="bfloat16", gpt_layers=2, gpt_batch=16,
                   rungs=(1, 4), costdb_steps=2, zoo=None, workdir=None):
    """The analysis layer and the cost database on ``ctx``:

    (a) ``verify_model`` over the zoo (``zoo``: names, default all),
        the GPT at ``cfg`` (rung ``rungs[-1]``) and ResNet-50 (``batch``,
        ``image``): no error;
    (b) ResNet-50's bench trainer (NHWC, block fusion) built with
        ``strict=True`` and without: two steps each, losses equal to the
        bit; a broken symbol refused with MXG005 naming its node, every
        kernel count 0 and ``memory_allocated()`` unchanged;
    (c) memlive's predicted peak against the allocator's measured one (and
        the drift, MXG018 exactly when it passes the tolerance) for the
        GPT's rung-4 forward (a strict bind) and the strict trainer's first
        step, beside the serve phase's repaired eager peak and graph pool
        (``serve_memory``) and PR 20's;
    (d) under an over-tight ``MXNET_TPU_MEMORY_BUDGET`` the ladder raises
        MXG017 before any forward: no capture, no launch, no compile;
    (e) with ``MXNET_TPU_COSTDB_SAMPLE=1``, ``costdb_steps`` ResNet-50
        steps (K5) and bf16 GPT steps at ``cfg``'s width and
        ``gpt_layers`` layers (K1, K3), each without a host sync: program,
        block and kernel records, every MFU at most 1, the flushed file
        read back by ``read_records(strict=True)``;
    (f) a ``CostModel`` fitted on those records, MXG010 over ResNet-50,
        and the ladder's rungs priced by it (``cost_model_ms``) beside
        their measured walls.

    The kernels' launches are counted over the whole phase.  Raises on any
    failed check."""
    from mxnet_tpu_torch import analysis, models, telemetry
    from mxnet_tpu_torch.analysis.verifier import Report
    from mxnet_tpu_torch.autotune import model as cost_model
    from mxnet_tpu_torch.telemetry import costdb
    on_card = ctx.device_type == "gpu"
    t_phase = time.perf_counter()
    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp()
    telemetry.reset()
    zero_kernel_counts()
    zero_flash_counts()
    out = {"context": str(ctx)}
    vocab, seq = cfg["vocab"], cfg["seq"]

    # (a) the verifier over the zoo and the two main paths' graphs
    t0 = time.perf_counter()
    zoo_out = {}
    for name in (zoo if zoo is not None else models._MODELS):
        _net, rep = analysis.verify_model(name)
        zoo_out[name] = {"errors": len(rep.errors),
                         "warnings": len(rep.warnings)}
    gpt_net = gpt_symbol(vocab, seq, cfg["d_model"], cfg["heads"],
                         cfg["layers"], dropout=0.0)
    resnet = models.get_model("resnet50", num_classes=1000,
                              image_shape="3,%d,%d" % (image, image))
    host_shapes = {"data": (batch, 3, image, image),
                   "softmax_label": (batch,)}
    verified = {
        "gpt": gpt_net.verify(data=(rungs[-1], seq),
                              softmax_label=(rungs[-1], seq)),
        "resnet50": resnet.verify(**host_shapes)}
    out["verify"] = {"zoo": zoo_out, "verify_s": time.perf_counter() - t0}
    out["verify"].update({k: {"errors": len(r.errors),
                              "warnings": len(r.warnings)}
                          for k, r in verified.items()})
    bad = [k for k, v in list(zoo_out.items()) + [
        (k, {"errors": len(r.errors)}) for k, r in verified.items()]
        if v["errors"]]
    if bad:
        raise SystemExit("analysis: verifier errors on %s: %s"
                         % (bad, [str(r) for r in verified.values()]))

    # (b) strict binds of ResNet-50's step, and a broken graph refused
    def resnet_trainer(strict):
        np.random.seed(0)
        return ShardedTrainer(
            resnet, build_mesh(devices=[ctx]),
            data_shapes={"data": host_shapes["data"]},
            label_shapes={"softmax_label": host_shapes["softmax_label"]},
            optimizer="sgd", learning_rate=0.1, momentum=0.9,
            weight_decay=1e-4, dtype=dtype, layout="NHWC",
            fuse_blocks=True, strict=strict)

    rng = np.random.RandomState(0)
    host_batch = {
        "data": rng.uniform(-1, 1, host_shapes["data"]).astype(np.float32),
        "softmax_label": rng.randint(0, 1000, batch).astype(np.float32)}
    losses = {}
    strict_tr = None
    # cuDNN's deterministic algorithms, as the resume drill takes them: the
    # second step's loss reads the first step's weight gradients
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for strict in (False, True):
            tr = resnet_trainer(strict)
            staged = tr.put_batch(host_batch)
            losses[strict] = [float(tr.step(staged)) for _ in range(2)]
            if strict:
                strict_tr, strict_staged = tr, staged
            del tr
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if losses[True] != losses[False]:
        raise SystemExit("analysis: strict losses %s, plain %s"
                         % (losses[True], losses[False]))
    broken = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Flatten(mx.sym.Pooling(mx.sym.var("data"), kernel=(1, 1),
                                      global_pool=True, pool_type="avg")),
        weight=mx.sym.var("fc_broken_weight", shape=(1000, 7)),
        num_hidden=1000, name="fc_broken"), name="softmax")
    gc.collect()
    mem_before = torch.cuda.memory_allocated() if on_card else None
    counts_before = kernel_counts()
    try:
        ShardedTrainer(broken, build_mesh(devices=[ctx]),
                       data_shapes={"data": host_shapes["data"]},
                       label_shapes={"softmax_label": (batch,)},
                       dtype=dtype, layout="NHWC", strict=True)
        raise SystemExit("analysis: the broken symbol was bound")
    except mx.MXNetError as e:
        refusal = str(e)
    mem_after = torch.cuda.memory_allocated() if on_card else None
    if "MXG005" not in refusal or "fc_broken" not in refusal \
            or kernel_counts() != counts_before or mem_after != mem_before:
        raise SystemExit("analysis: broken-graph refusal %r, counts %s -> "
                         "%s, memory %s -> %s" % (
                             refusal, counts_before, kernel_counts(),
                             mem_before, mem_after))
    out["strict"] = {"losses": losses[True], "losses_equal": True,
                     "refusal": refusal.splitlines()[:2],
                     "refusal_memory_delta": (mem_after - mem_before
                                              if on_card else None)}

    # (c) predicted against measured peaks
    params = gpt_params(gpt_net, seq)
    pred = mx.Predictor(gpt_net.tojson(),
                        {"arg:" + k: mx.nd.array(v, ctx=mx.cpu())
                         for k, v in params.items()},
                        {"data": (1, seq)}, ctx=ctx)
    del params
    with _env(MXNET_TPU_STRICT_BIND=1):
        rung = pred.reshaped({"data": (rungs[-1], seq)})
    exe = rung._executor
    _eager_dispatch(rung, np.zeros((rungs[-1], seq), np.float32))
    names = list(exe.arg_dict)
    out["memlive"] = {
        "gpt_rung%d_forward" % rungs[-1]: _memlive_drift(
            "executor.forward", gpt_net,
            {n: tuple(exe.arg_dict[n].shape) for n in names},
            {"types": {n: exe.arg_dict[n].data.dtype for n in names},
             "is_train": False, "inputs": set(names), "donate": ()}),
        "resnet50_step": _memlive_drift(
            "trainer.step", resnet, host_shapes,
            {"is_train": True, "mesh": {}, "tp_rules": {},
             "n_slots": strict_tr._n_slots, "donate": True})}
    del rung, exe
    if serve_memory:
        out["memlive"]["serve"] = {
            "eager_peak_bytes": serve_memory.get("eager_peak_bytes"),
            "graph_pool_bytes": serve_memory.get("graph_pool_bytes"),
            "pr20_eager_peak_bytes": PR20_EAGER_PEAK_BYTES,
            "pr20_graph_pool_bytes": PR20_GRAPH_POOL_BYTES}

    # (d) an over-tight budget: the ladder refuses before any forward
    captures = []
    real_capture = BatchLadder._capture
    BatchLadder._capture = lambda self, r: captures.append(r) or \
        real_capture(self, r)
    compiles = telemetry.counter("mxtpu_compile_total")
    compiles_before = compiles.get()
    counts_before = kernel_counts()
    limit = {} if on_card else {"MXNET_TPU_HBM_LIMIT_BYTES": 10 ** 5}
    try:
        with _env(MXNET_TPU_MEMORY_BUDGET=TIGHT_BUDGET, **limit):
            BatchLadder(pred, rungs=rungs)
        raise SystemExit("analysis: the ladder warmed under budget %s"
                         % TIGHT_BUDGET)
    except mx.MXNetError as e:
        gate = str(e)
    finally:
        BatchLadder._capture = real_capture
    launched = {k: v - counts_before[k]
                for k, v in kernel_counts().items() if v != counts_before[k]}
    if "MXG017" not in gate or captures or launched \
            or compiles.get() != compiles_before:
        raise SystemExit("analysis: budget gate %r, captures %s, launches "
                         "%s, compiles %d" % (gate, captures, launched,
                                              compiles.get()
                                              - compiles_before))
    out["budget_gate"] = {"budget_fraction": float(TIGHT_BUDGET),
                          "refusal": gate.splitlines()[:2],
                          "captures": 0, "launches": 0, "compiles": 0}

    # (e) the cost database, sampling every step
    with _env(MXNET_TPU_COSTDB_SAMPLE=1):
        costdb.reset()
        strict_tr.step(strict_staged)       # the reset's first: not timed
        resnet_syncs = []
        for _ in range(costdb_steps):
            _l, n = _sync_warnings(lambda: strict_tr.step(strict_staged))
            resnet_syncs.append(n)
        del strict_tr, strict_staged
        gc.collect()
        gpt_tr, gpt_staged = build_bench_trainer(
            vocab=vocab, seq=seq, d_model=cfg["d_model"], heads=cfg["heads"],
            layers=gpt_layers, batch=gpt_batch, dtype=dtype, ctx=ctx)
        gpt_tr.step(gpt_staged)             # its first dispatch: not timed
        gpt_syncs = []
        for _ in range(costdb_steps):
            _l, n = _sync_warnings(lambda: gpt_tr.step(gpt_staged))
            gpt_syncs.append(n)
        summary = gpt_tr.cost_summary()
        del gpt_tr, gpt_staged
        path = costdb.flush(os.path.join(workdir, "costdb"))
    records, skipped = costdb.read_records(path, strict=True)
    kinds = {}
    for r in records:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    kernels = sorted({r["name"] for r in records if r["kind"] == "kernel"})
    mfus = [r["mfu"] for r in records if r["mfu"] is not None]
    want_kernels = ["flash_attention_bwd", "flash_attention_fwd",
                    "matmul_stats"]
    if set(kinds) != {"program", "block", "kernel"} or skipped \
            or kernels != want_kernels or not mfus or max(mfus) > 1.0 \
            or any(resnet_syncs + gpt_syncs):
        raise SystemExit("analysis: costdb records %s, kernels %s, max mfu "
                         "%s, skipped %d, syncs %s %s" % (
                             kinds, kernels, max(mfus) if mfus else None,
                             skipped, resnet_syncs, gpt_syncs))
    programs = [{k: r[k] for k in (
        "name", "shapes", "wall_s", "flops", "bytes_accessed", "mfu",
        "bound", "count")} for r in records if r["kind"] == "program"]
    out["costdb"] = {
        "records": len(records), "by_kind": kinds, "kernels": kernels,
        "max_mfu": max(mfus), "programs": programs,
        "kernel_records": [{k: r[k] for k in (
            "name", "shapes", "dtypes", "wall_s", "flops", "mfu", "bound",
            "block_config")} for r in records if r["kind"] == "kernel"],
        "worst_mfu": summary["worst_mfu"], "backend": summary["backend"],
        "peak_flops": summary["peak_flops"], "peak_bw": summary["peak_bw"],
        "syncs_per_step": {"resnet50": resnet_syncs, "gpt": gpt_syncs},
        "file": os.path.basename(path)}

    # (f) the cost model: MXG010 over ResNet-50, the ladder's prices
    model = cost_model.CostModel().fit(records)
    model_path = model.save(os.path.join(workdir, "cost_model.json"))
    rep = analysis.verify_symbol(resnet, shapes=host_shapes,
                                 cost_model=model)
    slow = [d.node for d in rep if d.rule == "MXG010"]
    with _env(MXNET_TPU_SERVE_COST_MODEL=model_path):
        ladder = BatchLadder(pred, rungs=rungs)
    desc = ladder.describe()
    del ladder, pred
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if sorted(desc["cost_model_ms"]) != sorted(str(r) for r in rungs):
        raise SystemExit("analysis: the ladder priced %s"
                         % desc["cost_model_ms"])
    out["cost_model"] = {"n": model.stats["n"], "stats": model.stats,
                         "mxg010_nodes": len(slow), "mxg010_first": slow[:5],
                         "rung_cost_model_ms": desc["cost_model_ms"],
                         "rung_wall_ms": desc["wall_ms"]}
    out["kernel_launches"] = kernel_counts()
    out["flash_source_launches"] = flash_source_counts()
    out["phase_s"] = time.perf_counter() - t_phase
    if own_dir:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return out


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
        # a callable form that reads no program_id writes the whole output
        # at every grid index: once gives the same (at rtc_abs_full's
        # 262144 blocks the grid took some 90 s)
        gridded = "program_id" in plain.__code__.co_names
        mx.rtc.Rtc(name, arrays, [(oname, ref)], plain).push(
            [v for _n, v in arrays], [ref], grid if gridded else (1, 1, 1))
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
            with tf32_mode():
                control = tool.block_plain(*args).float()
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


# -------------------------------------------------------------- the model zoo
#: the zoo's ten networks, as ``tools.benchmark_score`` names them
ZOO_NETWORKS = ("mlp", "lenet", "alexnet", "vgg16", "resnet50",
                "inception-bn", "inception-v3", "inception-resnet-v2",
                "googlenet", "resnext")
#: the batch sizes scored, and the networks scored at batch 1 (the
#: latency regime; all ten took 31 s of the phase's 62 s)
ZOO_SCORE_BATCHES = (1, 32)
ZOO_SCORE_BATCH1 = ("resnet50", "inception-v3")
ZOO_SCORE_FORWARDS = 5
#: Inception-v3 at 299x299 on the fused route: the plan's blocks, 40 of
#: them on K5 (every 1x1 stride-1 Conv->BN->ReLU head)
INCEPTION_BLOCKS = 94
INCEPTION_K5_BLOCKS = 40
INCEPTION_BATCH = 128
INCEPTION_IMAGE = 299
#: the inception_train records: (records, seed) of 4-class JPEGs at
#: INCEPTION_RECORD_SIZE px, cropped to 299 at random
INCEPTION_RECORDS = {"train": (2048, 5), "val": (256, 6)}
INCEPTION_RECORD_SIZE = 320
INCEPTION_LR = 0.05
#: the zoo_serve model and the ladder it is served behind
ZOO_SERVE = {"model": "inception-bn", "data_shape": (3, 224, 224),
             "classes": 1000, "rungs": "1,4"}
#: served against the CPU: max |d log p| over the answers (serve_phase's)
TOL_ZOO_SERVE = 1e-3
#: tests/test_ctc_example.py's run and bound: 10 epochs of 384 strips
CTC_OCR = {"epochs": 10, "batch_size": 32, "n_train": 384, "lr": 0.015}
TOL_CTC_ACCURACY = 0.3


def inception_k5_shapes(batch=INCEPTION_BATCH, image=INCEPTION_IMAGE):
    """``{(M, K, N): convolutions}`` of Inception-v3's blocks on K5 at
    ``batch`` x ``image``: each 1x1 head's input rows (batch x H x W), its
    input and its output channels, read from the plan and the shapes
    ``infer_shape`` gives every internal output (on ``meta``)."""
    from mxnet_tpu_torch.analysis.fusion import plan_block_fusion
    from mxnet_tpu_torch.models import get_model
    net = get_model("inception-v3", num_classes=1000,
                    image_shape="3,%d,%d" % (image, image))
    plan = plan_block_fusion(net._topo(), net._entries, layout="NHWC",
                             is_train=True)
    internals = net.get_internals()
    _, outs, _ = internals.infer_shape(data=(batch, 3, image, image))
    shapes = dict(zip(internals.list_outputs(), outs))
    counts = {}
    for blk in plan.blocks.values():
        if not blk.pallas:
            continue
        src, idx = blk.conv.inputs[0]
        name = "%s_output" % src.name
        s = shapes[name if name in shapes else "%s_output%d"
                   % (src.name, idx)]
        key = (s[0] * s[2] * s[3], s[1], int(blk.conv.attrs["num_filter"]))
        counts[key] = counts.get(key, 0) + 1
    return dict(sorted(counts.items()))


def zoo_kernels_phase(shapes=None):
    """K5 against ``matmul_stats_plain`` at each distinct shape of
    Inception-v3's 40 K5 blocks (batch 128, 299x299, bf16): y within one
    bf16 ulp plus ``TOL_K5_Y_F32``, s1 and s2 by relative norm
    ``TOL_K5_SUMS``, two launches bit-identical, no padding (every K and N
    is a multiple of 8); per shape the card's time, the wrapper's host
    time, cuBLAS's bare product, the plain and library times and the
    bound, as the ResNet-50 rows have them."""
    shapes = shapes or inception_k5_shapes()
    gen = torch.Generator(device="cuda").manual_seed(3)
    entries = []
    for (m, k, n), count in shapes.items():
        x = torch.randn(m, k, generator=gen, device="cuda") \
            .to(torch.bfloat16)
        w_nk = (torch.randn(n, k, generator=gen, device="cuda")
                / k ** 0.5).to(torch.bfloat16)
        w2d = w_nk.t()
        c = 0.1 * torch.randn(n, generator=gen, device="cuda")
        matmul_stats.padded = 0
        out = matmul_stats(x, w2d, c)
        torch.cuda.synchronize()
        entry = {"shape": [m, k, n], "dtype": "bfloat16",
                 "launches_per_step": count, "padded": matmul_stats.padded,
                 "bit_identical": identical(out, matmul_stats(x, w2d, c))}
        entry.update(k5_check(*out, *matmul_stats_plain(x, w2d, c)))
        del out
        entry["ok"] = entry["ok"] and entry["bit_identical"] \
            and entry["padded"] == 0
        entry["tol_sums"] = TOL_K5_SUMS
        entry.update(k5_times(lambda: matmul_stats(x, w2d, c),
                              lambda: x @ w2d))
        entry.update(
            plain_ms=cuda_ms(lambda: matmul_stats_plain(x, w2d, c), 3),
            library_ms=cuda_ms(lambda: k5_library(x, w_nk, c), 20))
        entry.update(k5_bound(m, k, n, torch.bfloat16))
        entries.append(entry)
        del x, w_nk, w2d, c
    out = {"network": "inception-v3", "batch": INCEPTION_BATCH,
           "image": INCEPTION_IMAGE, "shapes": len(entries),
           "launches_per_step": sum(shapes.values()), "entries": entries}
    for key in ("device_ms", "kernel_ms", "dot_ms", "plain_ms",
                "library_ms", "bound_ms"):
        out["step_" + key] = sum(e[key] * e["launches_per_step"]
                                 for e in entries)
    bad = [e for e in entries if not e["ok"]]
    if bad:
        raise SystemExit("zoo_kernels: matmul_stats disagrees with its "
                         "plain version, differs between two launches or "
                         "was padded: %s" % json.dumps(bad))
    return out


def _inception_args(recs, ctx, image, batch, epochs, dtype, lr):
    from mxnet_tpu_torch.tools import train_imagenet
    return train_imagenet.parser().parse_args(
        ["--network", "inception-v3", "--data-train", recs["train"],
         "--data-val", recs["val"], "--image-shape",
         "3,%d,%d" % (image, image), "--num-classes", "1000",
         "--data-nthreads", str(os.cpu_count() or 1), "--disp-batches", "8",
         "--batch-size", str(batch), "--dtype", dtype, "--fused", "1",
         "--num-epochs", str(epochs), "--lr", str(lr), "--mom", "0.9",
         "--wd", "1e-4", "--top-k", "2", "--device-queue", "1"]
        + (["--cpu", "1"] if ctx.device_type == "cpu" else []))


def inception_train_phase(ctx, recs, image=INCEPTION_IMAGE,
                          batch=INCEPTION_BATCH, epochs=1, dtype="bfloat16",
                          lr=INCEPTION_LR, blocks=INCEPTION_BLOCKS,
                          k5_blocks=INCEPTION_K5_BLOCKS, timed_steps=3):
    """``tools.train_imagenet --network inception-v3 --image-shape
    3,299,299 --fused 1 --dtype bfloat16`` on ``ctx``: ``epochs`` of the
    train records through the native pipeline (raw uint8 normalized on the
    card) and a ``DevicePrefetchIter``, SGD momentum 0.9, wd 1e-4, NHWC,
    block fusion, validation on the held-out records.  Every count set to
    0 before and read after: K5 launched as many times a step as the plan
    has K5 blocks (0 on the CPU), every other kernel 0.  Every loss finite
    and the last below the first, every moving statistic moved, the plan
    ``blocks`` blocks with ``k5_blocks`` on K5.  Then, on a staged
    synthetic batch, the ms of a step and images/s (the best of two
    chains of ``timed_steps``), peak memory and a profile of one step
    (the device's busy share, K5's and cuDNN's shares)."""
    from mxnet_tpu_torch.models import get_model
    from mxnet_tpu_torch.tools import fit, train_imagenet
    on_card = ctx.device_type == "gpu"
    args = _inception_args(recs, ctx, image, batch, epochs, dtype, lr)
    net = get_model("inception-v3", num_classes=1000,
                    image_shape="3,%d,%d" % (image, image))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    history = {}
    zero_kernel_counts()
    t0 = time.perf_counter()
    trainer = fit.fit(args, net, train_imagenet.get_rec_iter,
                      history=history)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    by_source = flash_source_counts()
    losses = history["losses"]
    steps = len(losses)
    fusion = history.get("fusion")
    want = k5_blocks * steps if on_card else 0
    if counts["matmul_stats"] != want or any(
            v for k, v in counts.items() if k != "matmul_stats"):
        raise SystemExit("inception_train: launches %s over %d steps; want "
                         "matmul_stats %d, the rest 0"
                         % (counts, steps, want))
    if fusion is None or fusion["blocks"] != blocks \
            or fusion["pallas_blocks"] != k5_blocks:
        raise SystemExit("inception_train: fusion plan %s; want %d blocks, "
                         "%d on K5" % (fusion, blocks, k5_blocks))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SystemExit("inception_train: losses %s" % losses)
    still = [k for k, v in trainer.aux.items() if torch.equal(
        v, torch.ones_like(v) if k.endswith("moving_var")
        else torch.zeros_like(v))]
    if still:
        raise SystemExit("inception_train: moving statistics unchanged: %s"
                         % still)
    out = {"network": "inception-v3", "batch": batch, "image": image,
           "classes": 1000, "dtype": dtype, "layout": "NHWC",
           "fuse_blocks": True, "context": str(ctx), "queue_depth": 2,
           "optimizer": "sgd", "learning_rate": lr, "momentum": 0.9,
           "weight_decay": 1e-4, "epochs": epochs,
           "decoder": mx.io_native.decoder(),
           "params": sum(int(v.numel()) for v in trainer.params.values()),
           "steps": steps, "losses": losses,
           "epochs_detail": history["epochs"],
           "stage_walls_s": history["timings"], "fusion": fusion,
           "kernel_launches": counts, "flash_source_launches": by_source,
           "launches": {"matmul_stats": counts["matmul_stats"]},
           "launches_per_step": counts["matmul_stats"] / steps,
           "fit_wall_s": wall}
    if on_card:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    rng = np.random.RandomState(0)
    staged = trainer.put_batch({
        "data": rng.uniform(-1, 1, (batch, 3, image, image))
        .astype(np.float32),
        "softmax_label": rng.randint(0, 1000, batch).astype(np.float32)})
    trainer.step(staged)
    times = [time_chains(trainer, staged, timed_steps, timed_steps)[1]
             for _ in range(2)]
    step_s = min(times) / timed_steps
    out.update(timed_steps=timed_steps, repeats_s=times,
               step_ms=step_s * 1e3, images_per_s=batch / step_s)
    if on_card:
        # after the launch counts were read: these steps are not counted
        out["profile"] = profile_device(
            lambda: trainer.step(staged), top=12,
            marks={"k5": ("matmul_stats",),
                   "library_convs_gemms": (
                       "xmma", "cudnn", "cutlass", "implicit", "nvjet",
                       "gemm", "conv", "dgrad", "wgrad"),
                   "pytorch_elementwise_reductions": (
                       "elementwise_kernel", "reduce_kernel")})
    del trainer, staged
    gc.collect()
    return out


def reduced_inception(classes=10):
    """An ``Inception7A`` block (Inception-v3's mixed_0 widths) with a
    global-pool and FullyConnected head."""
    from mxnet_tpu_torch.models import inception_v3
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        x = inception_v3.Inception7A(data, 64, 64, 96, 96, 48, 64, "avg",
                                     32, "mixed")
        x = mx.sym.Pooling(x, kernel=(1, 1), global_pool=True,
                           pool_type="avg", name="global_pool")
        x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=classes,
                                  name="fc")
        return mx.sym.SoftmaxOutput(x, name="softmax")


def inception_check_phase(ctx, batch=8, image=17, channels=64,
                          check_ctx=None, k5_blocks=4, lr=0.1):
    """One f32 SGD step (momentum 0.9, wd 1e-4) of :func:`reduced_inception`
    at ``batch`` x ``channels`` x ``image``^2 (M = 2312 rows, not a
    multiple of K5's tiles) on the fused route on ``ctx`` (NHWC, block
    fusion, its ``k5_blocks`` 1x1 heads on the f32 K5) against the
    Executor route (``Module``, NCHW, unfused) on ``check_ctx`` (default:
    the CPU) from the same weights and batch: each parameter's and
    moving statistic's change within ``TOL_RESNET_CHECK`` and
    ``TOL_RESNET_CHECK_AUX`` (resnet_train_check's bounds)."""
    from mxnet_tpu_torch.io import DataBatch
    check_ctx = check_ctx or mx.cpu()
    shape = (batch, channels, image, image)
    rng = np.random.RandomState(4)
    host = {"data": rng.uniform(-1, 1, shape).astype(np.float32),
            "softmax_label": rng.randint(0, 10, batch).astype(np.float32)}
    trainer = ShardedTrainer(
        reduced_inception(), build_mesh(devices=[ctx]),
        data_shapes={"data": shape},
        label_shapes={"softmax_label": (batch,)}, layout="NHWC",
        fuse_blocks=True, dtype="float32", optimizer="sgd",
        learning_rate=lr, momentum=0.9, weight_decay=1e-4, seed=4)
    before = {k: v.to("cpu", copy=True) for k, v in
              list(trainer.params.items()) + list(trainer.aux.items())}
    matmul_stats.launches = 0
    loss = float(trainer.step(host))
    launches = matmul_stats.launches
    delta = {k: v.cpu() - before[k] for k, v in
             list(trainer.params.items()) + list(trainer.aux.items())}
    summary = trainer.fusion_summary()
    mod = mx.mod.Module(reduced_inception(), context=check_ctx)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(
        arg_params={k: mx.nd.array(before[k].numpy(), ctx=check_ctx)
                    for k in trainer.params},
        aux_params={k: mx.nd.array(before[k].numpy(), ctx=check_ctx)
                    for k in trainer.aux})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": lr, "momentum": 0.9, "wd": 1e-4})
    mod.forward(DataBatch([mx.nd.array(host["data"], ctx=check_ctx)],
                          [mx.nd.array(host["softmax_label"],
                                       ctx=check_ctx)]), is_train=True)
    mod.backward()
    mod.update()
    arg, aux = mod.get_params()
    ref = {k: torch.from_numpy(v.asnumpy()) - before[k]
           for k, v in list(arg.items()) + list(aux.items())}
    rel = {k: (delta[k] - d).norm().item() / max(d.norm().item(), 1e-30)
           for k, d in ref.items()}
    par = {k: v for k, v in rel.items()
           if not k.endswith(("moving_mean", "moving_var"))}
    aux_rel = {k: v for k, v in rel.items() if k not in par}
    out = {"model": "Inception7A + head", "data": list(shape),
           "rows": batch * image * image, "dtype": "float32",
           "contexts": [str(ctx), str(check_ctx)],
           "routes": ["fused NHWC ShardedTrainer", "Module (Executor)"],
           "loss": loss, "fusion": summary, "k5_launches": launches,
           "max_rel_update_diff": max(par.values()),
           "worst": max(par, key=par.get),
           "max_rel_aux_diff": max(aux_rel.values()),
           "worst_aux": max(aux_rel, key=aux_rel.get),
           "compared": len(rel), "tol": TOL_RESNET_CHECK,
           "tol_aux": TOL_RESNET_CHECK_AUX}
    want = k5_blocks if ctx.device_type == "gpu" else 0
    if launches != want or summary["pallas_blocks"] != k5_blocks:
        raise SystemExit("inception_check: matmul_stats launched %d times, "
                         "plan %s; want %d" % (launches, summary, want))
    if not (out["max_rel_update_diff"] <= TOL_RESNET_CHECK
            and out["max_rel_aux_diff"] <= TOL_RESNET_CHECK_AUX
            and np.isfinite(loss)):
        raise SystemExit("inception_check: %s" % json.dumps(out))
    return out


def zoo_score_phase(ctx, networks=ZOO_NETWORKS, batches=ZOO_SCORE_BATCHES,
                    num_batches=ZOO_SCORE_FORWARDS, dtype="bfloat16",
                    batch1=None):
    """``tools.benchmark_score`` over ``networks`` on both routes at each
    of ``batches`` (batch 1 for the ``batch1`` networks alone, when
    given): the
    Executor (f32 NCHW, Xavier weights) and the fused
    ``ShardedTrainer.forward`` (``dtype``, NHWC); images/s each, every
    count 0 (inference takes no kernel of the port)."""
    from mxnet_tpu_torch.tools import benchmark_score
    t0 = time.perf_counter()
    zero_kernel_counts()
    rates = {}
    for net in networks:
        shape = benchmark_score.image_shape_of(net)
        rates[net] = {"executor": {}, "fused": {}}
        for b in batches:
            if b == 1 and batch1 is not None and net not in batch1:
                continue
            rates[net]["executor"][str(b)] = benchmark_score.score(
                net, b, image_shape=shape, num_batches=num_batches, ctx=ctx)
            rates[net]["fused"][str(b)] = benchmark_score.score_fused(
                net, b, image_shape=shape, num_batches=num_batches,
                dtype=dtype, ctx=ctx)
            gc.collect()
    counts = kernel_counts()
    out = {"context": str(ctx), "networks": list(networks),
           "batches": list(batches),
           "batch1_networks": list(networks if batch1 is None else batch1),
           "forwards": num_batches,
           "routes": {"executor": "float32 NCHW",
                      "fused": "%s NHWC" % dtype},
           "images_per_s": rates, "kernel_launches": counts,
           "seconds": time.perf_counter() - t0}
    bad = [(n, r, b) for n, by in rates.items() for r, v in by.items()
           for b, x in v.items() if not (np.isfinite(x) and x > 0)]
    if bad or any(counts.values()):
        raise SystemExit("zoo_score: %s" % json.dumps(out))
    return out


def zoo_serve_phase(ctx, model=ZOO_SERVE["model"],
                    data_shape=ZOO_SERVE["data_shape"],
                    classes=ZOO_SERVE["classes"], rungs=ZOO_SERVE["rungs"],
                    requests=6, check_ctx=None):
    """The serving CLI's ``--model`` route (``serving.__main__``'s
    ``parser`` and ``_build_predictor``: the zoo model with fresh Xavier
    weights from seed 0) on ``ctx`` behind ``BatchLadder``, ``Batcher`` and
    ``Server``: ``requests`` one-image requests from threads and one of
    two images over HTTP; every answer finite, its rows summing to 1, and
    within ``TOL_ZOO_SERVE`` (max |d log p|) of a Predictor on
    ``check_ctx`` (default: the CPU) over the same weights."""
    from mxnet_tpu_torch.serving.__main__ import _build_predictor, parser
    check_ctx = check_ctx or mx.cpu()
    opts = parser().parse_args(
        ["--model", model, "--classes", str(classes), "--data-shape",
         ",".join(map(str, data_shape)), "--ladder", rungs]
        + (["--cpu", "1"] if ctx.device_type == "cpu" else []))
    rng = np.random.RandomState(2)
    images = rng.uniform(-1, 1, (requests + 2,) + tuple(data_shape)) \
        .astype(np.float32)
    zero_kernel_counts()
    t0 = time.perf_counter()
    pred = _build_predictor(opts)
    ladder = BatchLadder(pred, rungs=opts.ladder)
    batcher = Batcher(ladder, window_ms=50, queue_depth=64,
                      default_deadline_ms=600000)
    server = Server(ladder, batcher=batcher, port=0,
                    host="127.0.0.1").start()
    results, errors = {}, []

    def go(i):
        try:
            results[i] = batcher.submit({"data": images[i:i + 1]})[0]
        except Exception as e:  # collected and raised below
            errors.append(repr(e))

    try:
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(requests)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        req = urllib.request.Request(
            "http://127.0.0.1:%d/predict" % server.port,
            data=json.dumps({"data": images[requests:].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            results["http"] = np.asarray(json.loads(r.read())["outputs"][0],
                                         np.float32)
    finally:
        server.close()
        mx.telemetry.slo.stop_ticker()
    serve_s = time.perf_counter() - t0
    counts = kernel_counts()
    if errors or len(results) != requests + 1:
        raise SystemExit("zoo_serve: requests failed or were shed: %s"
                         % errors)
    exe = pred._executor
    weights = {k: v.asnumpy() for k, v in exe.arg_dict.items()
               if k not in ("data", "softmax_label")}
    weights.update({k: v.asnumpy() for k, v in exe.aux_dict.items()})
    ref = mx.Predictor(
        pred._symbol.tojson(),
        {k: mx.nd.array(v, ctx=check_ctx) for k, v in weights.items()},
        {"data": (requests + 2,) + tuple(data_shape)}, ctx=check_ctx)
    want = ref.forward(data=images).get_output(0)
    got = np.concatenate([results[i] for i in range(requests)]
                         + [results["http"]])
    finite = bool(np.isfinite(got).all())
    row_err = float(np.abs(got.sum(-1, dtype=np.float64) - 1).max())
    dlogp = float(np.abs(np.log(np.maximum(got, 1e-30))
                         - np.log(np.maximum(want, 1e-30))).max())
    out = {"model": model, "data_shape": list(data_shape),
           "classes": classes, "context": str(ctx), "rungs": rungs,
           "answered": len(results), "request_images": [1] * requests + [2],
           "dispatches_per_rung": {str(k): v for k, v in
                                   batcher.dispatch_counts().items()},
           "warm_wall_ms": ladder.describe()["wall_ms"], "serve_s": serve_s,
           "graphs": ladder.describe()["graphs"],
           "cross_check": str(check_ctx), "max_abs_dlogp": dlogp,
           "row_sum_err": row_err, "tol": TOL_ZOO_SERVE,
           "kernel_launches": counts}
    graphs = list(ladder.rungs) if ctx.device_type == "gpu" else []
    if not finite or row_err > 1e-4 or dlogp > TOL_ZOO_SERVE \
            or any(counts.values()) or out["graphs"] != graphs:
        raise SystemExit("zoo_serve: %s" % json.dumps(out))
    return out


def ring_gpt_phase(ctx, cfg=FULL, batch=16, dtype="bfloat16"):
    """One training step of ``build_bench_trainer`` at ``cfg`` with
    ``attention="ring"`` (``_contrib_RingAttention``) and one with
    ``"flash"``, each from the same seeded weights and batch, under
    PyTorch's deterministic algorithms: the losses and every parameter
    and optimizer state equal to the bit; on the card the bf16 K1 and K3
    launch once per layer in each step (by source)."""
    on_card = ctx.device_type == "gpu"
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for attention in ("ring", "flash"):
            trainer, staged = build_bench_trainer(
                vocab=cfg["vocab"], seq=cfg["seq"], d_model=cfg["d_model"],
                heads=cfg["heads"], layers=cfg["layers"], batch=batch,
                dtype=dtype, ctx=ctx, attention=attention)
            zero_kernel_counts()
            loss = float(trainer.step(staged))
            state = {k: v.clone() for k, v in trainer.params.items()}
            state.update({"%s:%d" % (k, i): s.clone() for k, v in
                          trainer.opt_state.items() for i, s in enumerate(v)})
            runs[attention] = (loss, state, kernel_counts(),
                               flash_source_counts())
            del trainer, staged
            gc.collect()
    finally:
        torch.use_deterministic_algorithms(False)
    (rl, rs, rc, rsrc), (fl, fs, fc, fsrc) = runs["ring"], runs["flash"]
    differ = [k for k in fs if not torch.equal(rs[k], fs[k])]
    want = cfg["layers"] if on_card else 0
    src = "flash_attention_fwd_sm90" if dtype == "bfloat16" \
        else "flash_attention_fwd"
    out = {"config": cfg, "batch": batch, "dtype": dtype,
           "context": str(ctx), "losses": {"ring": rl, "flash": fl},
           "compared": len(fs), "differing": differ[:5],
           "bit_identical": rl == fl and not differ,
           "kernel_launches": rc, "flash_source_launches": rsrc,
           "flash_step_launches": fc}
    fwd = rsrc[src]
    bwd = rsrc[src.replace("fwd", "bwd")]
    if not out["bit_identical"] or rc != fc or fwd != want or bwd != want:
        raise SystemExit("ring_gpt: %s; want %d K1 and K3 launches"
                         % (json.dumps(out), want))
    return out


def contrib_ops_phase(device="cuda", check_device="cpu"):
    """The op corpus's cases of ``op_corpus.CONTRIB_OPS`` (CTCLoss,
    quantize, dequantize, fft, ifft, count_sketch, SwitchMoE and
    RingAttention at a head dim the flash kernels do not take) on
    ``device`` against ``check_device``, forward and the gradient of
    ``sum(out * cot)`` within ``TOL_OP_CORPUS`` (quantize to the bit;
    count_sketch's duplicate buckets are summed by ``index_add`` in
    another order on the card, well inside it); on the card each case's
    forward and backward under ``set_sync_debug_mode("error")``: no host
    sync; no kernel launched."""
    t0 = time.perf_counter()
    zero_kernel_counts()
    rows = op_corpus.card_vs_cpu(device, check_device=check_device,
                                 ops=op_corpus.CONTRIB_OPS)
    syncs = {}
    if torch.device(device).type == "cuda":
        for case in op_corpus.CASES:
            op = get_op(case.op)
            if op.name not in op_corpus.CONTRIB_OPS:
                continue
            attrs = op.parse_attrs({k: str(v) for k, v in
                                    case.attrs.items()})
            ts = [torch.from_numpy(x).to(device)
                  for x in op_corpus.inputs_of(case)]
            for i in case.diff:
                ts[i].requires_grad_(True)
            torch.cuda.synchronize()

            def fwd_bwd(op=op, attrs=attrs, ts=ts, case=case):
                outs = apply_op(op, attrs, OpContext(
                    device=torch.device(device)), *ts)
                floats = [o for o in outs if o.requires_grad]
                if floats:
                    torch.autograd.grad(
                        sum(o.float().sum() for o in floats),
                        [ts[i] for i in case.diff], allow_unused=True)
            syncs[case.id] = _sync_free(fwd_bwd)
    counts = kernel_counts()

    def worst(r):
        return max(r["out_err"], r["grad_err"] or 0.0)

    over = [r for r in rows if worst(r) > TOL_OP_CORPUS]
    by_op = {}
    for r in rows:
        by_op[r["op"]] = max(by_op.get(r["op"], 0.0), worst(r))
    out = {"devices": [str(device), str(check_device)],
           "ops": sorted(by_op), "cases": len(rows), "worst": by_op,
           "over": over, "tol": TOL_OP_CORPUS,
           "host_syncs": {k: v for k, v in syncs.items() if v},
           "sync_checked": len(syncs), "kernel_launches": counts,
           "kernel_launches_total": sum(counts.values()),
           "seconds": time.perf_counter() - t0}
    if over or out["host_syncs"] or any(counts.values()) \
            or set(by_op) != op_corpus.CONTRIB_OPS:
        raise SystemExit("contrib_ops: %s" % json.dumps(out))
    return out


def ctc_ocr_phase(ctx, min_accuracy=TOL_CTC_ACCURACY, seed=0, **over):
    """``tools.lstm_ocr.train`` at ``CTC_OCR`` (``tests/test_ctc_example.py``'s
    run: 10 epochs of 384 strips, batch 32, Adam lr 0.015) on ``ctx``, numpy's
    global generator seeded for the shuffle: the losses finite and falling,
    the exact-match accuracy above ``min_accuracy`` (None: not held), every
    count 0 (the LSTM, FullyConnected and CTCLoss take no kernel of the
    port); ms per batch."""
    from mxnet_tpu_torch.tools import lstm_ocr
    cfg = dict(CTC_OCR, **over)
    np.random.seed(seed)
    zero_kernel_counts()
    history = {}
    t0 = time.perf_counter()
    _mod, acc = lstm_ocr.train(ctx=ctx, history=history, **cfg)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    out = dict(cfg, context=str(ctx), exact_match=acc,
               losses=history["losses"], accuracy=history["accuracy"],
               median_batch_ms=float(np.median(history["batch_ms"])),
               wall_s=wall, kernel_launches=counts,
               min_accuracy=min_accuracy)
    losses = history["losses"]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0] \
            or any(counts.values()) \
            or (min_accuracy is not None and not acc > min_accuracy):
        raise SystemExit("ctc_ocr: %s" % json.dumps(out))
    return out


#: what the summary line keeps of each K5, K7 and K8 case
K5_SHAPE_KEYS = ("shape", "device_ms", "kernel_ms", "host_us", "dot_ms",
                 "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "bound_split_tf32_ms", "bound_cuda_core_ms", "max_abs_err",
                 "s1_rel_norm", "s2_rel_norm", "bit_identical")


# ------------------------------------------------------------ autotune
#: the flash shapes whose every tile is timed: the GPT's training step
#: (bf16, batch 16) and its serving rung 4 (f32), both causal
AUTOTUNE_FLASH = [TRAIN_SHAPE, (4, 1024, 16, 64, torch.float32, True)]
#: every head dim's tiles, checked (not timed) at a small shape
AUTOTUNE_FLASH_CHECK = [(2, 256, 4, d, dt, True) for d in (32, 64, 128)
                        for dt in (torch.float32, torch.bfloat16)]


def _flash_tile_entries(case, gen, timed):
    """Every tile :func:`kernel_tiles` lists of the flash forward and
    backward at ``case`` against the plain versions, under the kernels
    phases' tolerances (the backward from the built-in forward's o and
    lse); with ``timed``, each tile's device time (a CUDA graph of launches,
    ``autotune.measure_device``)."""
    from mxnet_tpu_torch.autotune import search as tsearch
    from mxnet_tpu_torch.ops.flash_attention import kernel_tiles
    b, t, h, d, dt, causal = case
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                   .to(dt) for _ in range(4))
    f32 = dt == torch.float32
    ro, rl = flash_attention_plain(q.float(), k.float(), v.float(), causal)
    out = {"shape": [b, t, h, d], "dtype": str(dt).replace("torch.", ""),
           "causal": causal, "fwd": [], "bwd": []}
    tol_o = TOL_F32 if f32 else TOL_BF16
    for tile in kernel_tiles("fwd", dt, d):
        o, lse = flash_attention_fwd(q, k, v, causal, blocks=tile)
        torch.cuda.synchronize()
        e = {"tile": list(tile),
             "err_o": (o.float() - ro).abs().max().item(),
             "err_lse": (lse - rl).abs().max().item()}
        e["ok"] = e["err_o"] <= tol_o and e["err_lse"] <= TOL_F32
        if timed:
            e["ms"] = 1e3 * tsearch.measure_device(
                lambda: flash_attention_fwd(q, k, v, causal, blocks=tile),
                repeats=3, chain=10, device="cuda")
        out["fwd"].append(e)
        del o, lse
    o, lse = flash_attention_fwd(q, k, v, causal)
    ref = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                    o.float(), lse, do.float(), causal)
    for tile in kernel_tiles("bwd", dt, d):
        got = flash_attention_bwd(q, k, v, o, lse, do, causal, blocks=tile)
        torch.cuda.synchronize()
        e = {"tile": list(tile), "ok": True}
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            err = (x.float() - r).abs().max().item()
            rel = (x.float() - r).norm().item() / r.norm().item()
            e[name + "_err"], e[name + "_rel_norm"] = err, rel
            e["ok"] = e["ok"] and err <= TOL_BWD_MAX[dt] * r.abs().max(
            ).item() + (1e-5 if f32 else 0.0) and rel <= TOL_BWD_NORM[dt]
        if timed:
            e["ms"] = 1e3 * tsearch.measure_device(
                lambda: flash_attention_bwd(q, k, v, o, lse, do, causal,
                                            blocks=tile),
                repeats=3, chain=5, device="cuda")
        out["bwd"].append(e)
        del got
    del q, k, v, do, ro, rl, o, lse, ref
    return out


def autotune_kernels_phase():
    """Every tile the tuners may pick, against the plain versions on the
    card: K1 and K3 at the GPT's training shape (bf16) and serving shape
    (f32), and at every head dim at (2, 256, 4, D); K5 at every config
    ``candidate_matmul_configs`` lists (each width it takes at N, at its
    built-in grid rows and half of them) at the 8 ResNet-50 shapes in bf16
    and the 2 f32 shapes, under K5's criteria.  Each timed one's device
    time (a CUDA graph of launches) and the built-in tile's beside it."""
    from mxnet_tpu_torch.autotune import search as tsearch
    from mxnet_tpu_torch.ops import fused as tfused
    gen = torch.Generator(device="cuda").manual_seed(3)
    flash = [_flash_tile_entries(c, gen, True) for c in AUTOTUNE_FLASH]
    flash += [_flash_tile_entries(c, gen, False)
              for c in AUTOTUNE_FLASH_CHECK]
    sms = tfused._partial_rows(torch.device("cuda", 0))
    k5 = []
    cases = [(m, k, n, torch.bfloat16) for m, k, n, _c in K5_BENCH_SHAPES]
    cases += [(m, k, n, torch.float32) for m, k, n in K5_F32_SHAPES]
    for m, k, n, dt in cases:
        x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        w2d = (torch.randn(n, k, generator=gen, device="cuda")
               / k ** 0.5).to(dt).t()
        c = 0.1 * torch.randn(n, generator=gen, device="cuda")
        ref = matmul_stats_plain(x, w2d, c)
        dtype = str(dt).replace("torch.", "")
        entry = {"shape": [m, k, n], "dtype": dtype, "configs": []}
        for cfg in tsearch.candidate_matmul_configs(m, n, dtype, sms=sms):
            got = matmul_stats(x, w2d, c, config=cfg)
            torch.cuda.synchronize()
            e = dict(cfg, **k5_check(*got, *ref))
            e["device_ms"] = matmul_stats_experiment.device_ms(
                lambda: matmul_stats(x, w2d, c, config=cfg))
            entry["configs"].append(e)
            del got
        entry["heuristic"] = tfused.heuristic_config(m, n, dt, sms)
        entry.update(k5_bound(m, k, n, dt))
        k5.append(entry)
        del x, w2d, c, ref
    bad = [e for f in flash for e in f["fwd"] + f["bwd"] if not e["ok"]]
    bad += [c for e in k5 for c in e["configs"] if not c["ok"]]
    if bad:
        raise SystemExit("autotune_kernels: a tile disagrees with the plain "
                         "version: %s" % json.dumps(bad))
    return {"flash": flash, "matmul_stats": k5}


#: the bench trainer's steps in each of autotune's two dispatch runs, and
#: the bound on the relative difference of their losses: the tuned tiles
#: (and a committed plan's decisions) sum in other orders than the built-in
#: ones, in bf16
AUTOTUNE_RESNET_STEPS = 4
TOL_TUNED_LOSS = 5e-2
#: the GPT's flash keys autotune tunes: the bf16 training step's forward
#: and backward, and the f32 serving rungs' forward (all causal)
AUTOTUNE_GPT_KEYS = [("flash_fwd", "16x1024x16x64", "bfloat16"),
                     ("flash_bwd", "16x1024x16x64", "bfloat16"),
                     ("flash_fwd", "1x1024x16x64,4x1024x16x64", "float32")]


def _tool_main(module, argv):
    """``module.main(argv + ["--json"])`` in this process: its exit code
    and the document it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(list(argv) + ["--json"])
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def _tool_process(module, argv):
    """``python -m module argv --json`` from the repo's root, in a process
    of its own: the document it printed; raises on a non-zero exit."""
    res = subprocess.run(
        [sys.executable, "-m", module] + list(argv) + ["--json"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode != 0:
        raise SystemExit("autotune: %s failed (%d): %s"
                         % (module, res.returncode, res.stderr[-2000:]))
    return json.loads(res.stdout.strip().splitlines()[-1])


def _autotune_env(**values):
    """Set (or, for None, remove) the autotune and plan variables and
    re-read the tuning cache: a fresh generation and zeroed counts."""
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.analysis import plansearch
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    autotune.reload_cache()
    autotune.reset_stats()
    plansearch.reset_stats()


def _resnet_dispatch(steps, ctx):
    """The bench configuration's ResNet-50 trainer (batch 128, 224, bf16,
    NHWC, fused): ``steps`` steps with K5's count set to 0 just before;
    the losses, K5's launches a step, the plan's K5 blocks, the tune and
    plan lookups."""
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.analysis import plansearch
    trainer, staged = build_resnet_trainer(128, 224, ctx=ctx)
    matmul_stats.launches = 0
    losses = [float(trainer.step(staged)) for _ in range(steps)]
    torch.cuda.synchronize()
    out = {"losses": losses,
           "k5_launches_per_step": matmul_stats.launches / steps,
           "pallas_blocks": trainer.fusion_summary()["pallas_blocks"],
           "plan_id": trainer.fusion_summary().get("plan_id"),
           "tune": {k: v for k, v in autotune.summary().items()
                    if k in ("mode", "entries", "hits", "misses",
                             "searches")},
           "plan": plansearch.stats()}
    del trainer, staged
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _wrapper_us(fn, calls=2000):
    """Host microseconds a call of ``fn`` (warmed; the card's work at the
    tiny shapes is a few microseconds)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def autotune_host_costs(rounds=3, calls=1000):
    """The K5 and K1 wrappers' host microseconds a call at tiny bf16 shapes
    ((256, 64) @ (64, 64); (1, 128, 1, 64) causal) with the tuning cache
    off, empty (every lookup a miss, resolved once) and hit (the key
    committed with the built-in tile): ``rounds`` rounds, the modes in a
    rotated order in each (the host's speed drifts over seconds), the
    median of each mode's readings."""
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.ops import fused as tfused
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(256, 64, generator=gen, device="cuda").bfloat16()
    w = torch.randn(64, 64, generator=gen, device="cuda").bfloat16()
    c = torch.zeros(64, device="cuda")
    q, k, v = (torch.randn(1, 128, 1, 64, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    modes = ["off", "empty", "hit"]
    got = {m: {"k5_us": [], "k1_us": []} for m in modes}
    lookups = {}
    for r in range(rounds):
        for mode in modes[r % 3:] + modes[:r % 3]:
            _autotune_env(MXNET_TPU_AUTOTUNE="off" if mode == "off"
                          else None, MXNET_TPU_TUNE_CACHE=None)
            if mode == "hit":
                autotune.put("matmul_stats", [(256, 64), (64, 64)],
                             ["bfloat16", "bfloat16"],
                             tfused.heuristic_config(256, 64,
                                                     torch.bfloat16),
                             backend="gpu", persist=False)
                autotune.put("flash_attention_fwd", [(1, 128, 1, 64)],
                             ["bfloat16"], {"block_q": 128, "block_k": 128},
                             extra={"causal": True}, backend="gpu",
                             persist=False)
            got[mode]["k5_us"].append(
                _wrapper_us(lambda: matmul_stats(x, w, c), calls))
            got[mode]["k1_us"].append(
                _wrapper_us(lambda: flash_attention_fwd(q, k, v, True),
                            calls))
            lookups[mode] = {kk: vv for kk, vv in
                             autotune.summary().items()
                             if kk in ("hits", "misses")}
    _autotune_env(MXNET_TPU_AUTOTUNE=None)
    return {m: {"k5_us": float(np.median(got[m]["k5_us"])),
                "k1_us": float(np.median(got[m]["k1_us"])),
                "k5_us_all": got[m]["k5_us"], "k1_us_all": got[m]["k1_us"],
                "lookups": lookups[m]} for m in modes}


def autotune_capture_check():
    """``MXNET_TPU_AUTOTUNE=search`` and a key the cache lacks: a flash
    forward captured into a CUDA graph reads the miss as a plain miss (no
    search: its synchronisations would break the capture), and the same
    call outside the capture searches and commits."""
    from mxnet_tpu_torch import autotune
    _autotune_env(MXNET_TPU_AUTOTUNE="search", MXNET_TPU_TUNE_CACHE=None)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(1, 256, 2, 64, generator=gen, device="cuda")
               for _ in range(3))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, _lse = flash_attention_fwd(q, k, v, True)
    graph.replay()
    torch.cuda.synchronize()
    captured = {kk: vv for kk, vv in autotune.summary().items()
                if kk in ("hits", "misses", "searches")}
    flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    after = {kk: vv for kk, vv in autotune.summary().items()
             if kk in ("hits", "misses", "searches", "entries")}
    del graph, o
    _autotune_env(MXNET_TPU_AUTOTUNE=None)
    if captured["searches"] != 0 or captured["misses"] != 1 \
            or after["searches"] != 1:
        raise SystemExit("autotune: a search ran inside a CUDA-graph "
                         "capture, or none outside it: %s then %s"
                         % (captured, after))
    return {"in_capture": captured, "after": after}


def _tile_times(entry, kind):
    """``{"heuristic", "legal", "winner", "ms"}`` of one flash case's
    ``kind`` (``fwd``/``bwd``) tiles from autotune_kernels."""
    rows = entry[kind]
    best = min(rows, key=lambda e: e["ms"])
    return {"shape": entry["shape"], "dtype": entry["dtype"],
            "heuristic": rows[0]["tile"], "heuristic_ms": rows[0]["ms"],
            "legal": [e["tile"] for e in rows], "winner": best["tile"],
            "winner_ms": best["ms"],
            "ms": {"x".join(map(str, e["tile"])): e["ms"] for e in rows}}


def _k5_tile_times(entry):
    """The same for one K5 shape: configs ``{"bn", "rows"}``."""
    rows = entry["configs"]
    best = min(rows, key=lambda e: e["device_ms"])
    return {"shape": entry["shape"], "dtype": entry["dtype"],
            "heuristic": entry["heuristic"],
            "heuristic_ms": rows[0]["device_ms"],
            "legal": [{"bn": e["bn"], "rows": e["rows"]} for e in rows],
            "winner": {"bn": best["bn"], "rows": best["rows"]},
            "winner_ms": best["device_ms"]}


def autotune_phase(ctx, workdir, cfg=FULL):
    """The tuners, the cache and the plan search on the card: every tile
    against the plain versions (:func:`autotune_kernels_phase`); the
    ResNet-50 zoo tuning through ``tools.autotune`` twice (each as its own
    process), the GPT's flash keys, the ResNet-50 plan through
    ``tools.plan_search`` twice (keyed by the trainer's one-device mesh);
    then from the committed cache the bench trainer (every tune and plan
    lookup a hit, K5 on each of the plan's K5 blocks, losses within
    TOL_TUNED_LOSS of a run with both off), the bf16 GPT step and the f32
    serving ladder (the flash lookups hits, each rung's replay equal to its
    eager forward to the bit); no search inside a capture; the wrappers'
    host cost.  Leaves the cache empty and the variables unset, so that
    nothing after it changes."""
    from mxnet_tpu_torch import autotune
    from mxnet_tpu_torch.analysis import plansearch
    from mxnet_tpu_torch.tools import autotune as tune_tool
    from mxnet_tpu_torch.tools import plan_search as plan_tool
    t0 = time.perf_counter()
    tiles = autotune_kernels_phase()
    kernels_s = time.perf_counter() - t0
    cache = os.path.join(workdir, "tunecache")
    resnet_args = ["--model", "resnet50", "--batch", "128", "--dtype",
                   "bfloat16", "--cache", cache]
    # both runs as their own processes: the CLI as a user calls it
    t1 = time.perf_counter()
    first = _tool_process("mxnet_tpu_torch.tools.autotune", resnet_args)
    tune_s = time.perf_counter() - t1
    second = _tool_process("mxnet_tpu_torch.tools.autotune", resnet_args)
    _autotune_env(MXNET_TPU_TUNE_CACHE=cache)
    if second["tuned"] != 0 or second["cached"] != \
            first["tuned"] + first["cached"] or first["tuned"] == 0:
        raise SystemExit("autotune: the second ResNet-50 run searched %s "
                         "(want 0 and every key cached): first %s"
                         % (second, first))
    gpt = []
    for op, shapes, dtype in AUTOTUNE_GPT_KEYS:
        for run in (0, 1):
            rc, doc = _tool_main(tune_tool, [
                "--op", op, "--shapes", shapes, "--causal", "--dtype",
                dtype, "--cache", cache])
            if rc != 0 or (run == 1 and doc["tuned"] != 0):
                raise SystemExit("autotune: %s %s run %d: %s"
                                 % (op, shapes, run, doc))
            if run == 0:
                gpt.append(doc)
    plan_args = ["--model", "resnet50", "--batch", "128", "--num-classes",
                 "1000", "--dtype", "bfloat16", "--mesh", "data=1,model=1",
                 "--cache", cache]
    t1 = time.perf_counter()
    rc, plan1 = _tool_main(plan_tool, plan_args)
    plan_s = time.perf_counter() - t1
    rc2, plan2 = _tool_main(plan_tool, plan_args)
    if rc or rc2 or plan1["cached"] or not plan2["cached"] \
            or plan1["wall_s"] > plan1["greedy_wall_s"]:
        raise SystemExit("autotune: plan_search: %s then %s"
                         % (plan1, plan2))
    # dispatch: the bench trainer with both off, then from the cache
    _autotune_env(MXNET_TPU_AUTOTUNE="off", MXNET_TPU_PLAN_SEARCH="off",
                  MXNET_TPU_TUNE_CACHE=None)
    off = _resnet_dispatch(AUTOTUNE_RESNET_STEPS, ctx)
    _autotune_env(MXNET_TPU_AUTOTUNE=None, MXNET_TPU_PLAN_SEARCH=None,
                  MXNET_TPU_TUNE_CACHE=cache)
    tuned = _resnet_dispatch(AUTOTUNE_RESNET_STEPS, ctx)
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(tuned["losses"], off["losses"]))
    if tuned["tune"]["misses"] or not tuned["tune"]["hits"] \
            or tuned["plan"] != {"hits": 1, "misses": 0} \
            or tuned["k5_launches_per_step"] != tuned["pallas_blocks"] \
            or off["k5_launches_per_step"] != K5_PER_STEP \
            or loss_rel > TOL_TUNED_LOSS \
            or not all(np.isfinite(tuned["losses"])):
        raise SystemExit("autotune: the ResNet-50 dispatch from the cache: "
                         "%s against %s (loss rel %g)"
                         % (tuned, off, loss_rel))
    # the bf16 GPT step from the cache
    _autotune_env()
    trainer, staged = build_bench_trainer(
        vocab=cfg["vocab"], seq=cfg["seq"], d_model=cfg["d_model"],
        heads=cfg["heads"], layers=cfg["layers"], batch=16,
        dtype="bfloat16", ctx=ctx)
    zero_flash_counts()
    gpt_losses = [float(trainer.step(staged)) for _ in range(2)]
    gpt_step = {"losses": gpt_losses, "launches": flash_counts(),
                "tune": {k: v for k, v in autotune.summary().items()
                         if k in ("hits", "misses", "searches")},
                "tuned": autotune.summary()["tuned"]}
    del trainer, staged
    gc.collect()
    torch.cuda.empty_cache()
    if gpt_step["tune"]["misses"] or gpt_step["tune"]["hits"] != 2 \
            or not all(np.isfinite(gpt_losses)):
        raise SystemExit("autotune: the GPT step from the cache: %s"
                         % gpt_step)
    # the f32 serving ladder from the cache
    _autotune_env()
    ladder = _ladder_from_cache(ctx, cfg, workdir)
    if ladder["tune"]["misses"] or ladder["tune"]["hits"] != 2 \
            or not all(r["bit_equal"] for r in ladder["rungs"].values()):
        raise SystemExit("autotune: the ladder from the cache: %s" % ladder)
    capture = autotune_capture_check()
    host = autotune_host_costs()
    _autotune_env(MXNET_TPU_TUNE_CACHE=None, MXNET_TPU_AUTOTUNE=None,
                  MXNET_TPU_PLAN_SEARCH=None)
    autotune.CACHE.clear()
    flash = {"%s_%s_%s" % (kind, e["dtype"], e["shape"][0]):
             _tile_times(e, kind)
             for e in tiles["flash"] if "ms" in e["fwd"][0]
             for kind in ("fwd", "bwd")}
    return {"tiles": tiles, "flash_tiles": flash,
            "k5_tiles": [_k5_tile_times(e) for e in tiles["matmul_stats"]],
            "tune_first": {k: first[k] for k in ("tuned", "cached")},
            "tune_first_keys": first["keys"], "tune_second":
                {k: second[k] for k in ("tuned", "cached")},
            "gpt_keys": [d["keys"] for d in gpt],
            "plan_first": {k: plan1.get(k) for k in (
                "graph", "plan_id", "searched", "measured", "predicted_s",
                "greedy_predicted_s", "wall_s", "greedy_wall_s",
                "candidates")},
            "plan_second": {k: plan2.get(k) for k in ("cached", "plan_id")},
            "resnet_off": off, "resnet_tuned": tuned,
            "resnet_loss_rel": loss_rel, "gpt_step": gpt_step,
            "ladder": ladder, "capture": capture, "host_us": host,
            "kernels_s": kernels_s, "tune_s": tune_s, "plan_s": plan_s,
            "wall_s": time.perf_counter() - t0}


def _ladder_from_cache(ctx, cfg, workdir, rungs=(1, 4)):
    """The f32 GPT served from one CUDA graph a rung, from the cache:
    each rung's replay against the eager forward of the same rung."""
    from mxnet_tpu_torch import autotune
    seq = cfg["seq"]
    net = gpt_symbol(cfg["vocab"], seq, cfg["d_model"], cfg["heads"],
                     cfg["layers"], dropout=0.0)
    params = gpt_params(net, seq)
    prefix = os.path.join(workdir, "gpt_tuned")
    net.save(prefix + "-symbol.json")
    mx.nd.save(prefix + "-0000.params",
               {"arg:" + k: mx.nd.array(v, ctx=mx.cpu())
                for k, v in params.items()})
    del params
    tokens = np.random.RandomState(2).randint(
        0, cfg["vocab"], (max(rungs), seq)).astype(np.float32)
    pred = mx.Predictor(prefix + "-symbol.json", prefix + "-0000.params",
                        {"data": (1, seq)}, ctx=ctx)
    eager = {r: pred.reshaped({"data": (r, seq)}) for r in rungs}
    ladder = BatchLadder(pred, rungs=rungs)
    out = {"rungs": {}}
    for r in rungs:
        got = ladder.dispatch(r, {"data": tokens[:r]})[0]
        ref = _eager_dispatch(eager[r], tokens[:r])
        out["rungs"][str(r)] = {
            "bit_equal": bool(np.array_equal(got, ref)),
            "max_abs_dlogp": float(np.abs(np.log(got) - np.log(ref)).max())}
    out["tune"] = {k: v for k, v in autotune.summary().items()
                   if k in ("hits", "misses", "searches")}
    out["tuned"] = autotune.summary()["tuned"]
    del ladder, eager, pred
    gc.collect()
    torch.cuda.empty_cache()
    return out


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


def k5_inception_fields(zoo_k5, inception):
    """K5 on Inception-v3's path for the kernel summary line: zoo_kernels'
    19 shapes summed over one step's 40 launches (the card's time, the
    time with the host's share, cuBLAS's bare product, plain, library and
    bound) beside inception_train's launches."""
    return {"launches": inception["launches"]["matmul_stats"],
            "steps": inception["steps"],
            "launches_per_step": inception["launches_per_step"],
            "per": "one Inception-v3 training step at batch 128, 299x299, "
                   "%d launches, bf16" % zoo_k5["launches_per_step"],
            "ms": zoo_k5["step_device_ms"],
            "wall_ms": zoo_k5["step_kernel_ms"],
            "dot_ms": zoo_k5["step_dot_ms"],
            "plain_ms": zoo_k5["step_plain_ms"],
            "library_ms": zoo_k5["step_library_ms"],
            "bound_ms": zoo_k5["step_bound_ms"],
            "max_abs_err": max(e["max_abs_err"] for e in zoo_k5["entries"]),
            "shapes": [{k: e[k] for k in ("launches_per_step",)
                        + K5_SHAPE_KEYS if k in e}
                       for e in zoo_k5["entries"]]}


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


#: the data-parallel phase: the launcher, the two-rank jobs' time limit,
#: and its bounds.  Losses: each leg's largest relative difference from
#: one process at the global batch over its steps (bf16: a rank's GEMMs
#: run at half the rows, where cuBLAS may pick other kernels, so the bits
#: differ; the f32 semantics are held to rtol 1e-5 against JAX by
#: tests/test_torch_dist_trainer.py).  State: ResNet-50's moving
#: statistics after its first step (the cross-rank sums of the forward),
#: as ||two ranks - one process|| over ||one process's step||, where its
#: control (every rank's BatchNorm over its own rows) must read above the
#: bound.  Both ResNet-50 bounds lie between the sound leg and the
#: control: on an NVIDIA H100 80GB HBM3 at 700 W the sound leg read losses
#: 2.38e-3 and moving statistics 2.81e-3 (one process with the batch's
#: halves swapped 2.35e-3 and 2.70e-3), the control 1.05e-2 and 0.177;
#: a job that never updates would read 0.149 (PERF.md).
LAUNCH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "mxnet_tpu_torch", "tools", "launch.py")
DIST_TIMEOUT_S = 400
TOL_DIST_LOSS = {"gpt": 1e-3, "resnet": 6e-3}
TOL_DIST_AUX = 0.05


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch_job(mode, out, n=2, extra=(), env=None, worker=None):
    """``tools/launch.py -n n -- python -m mxnet_tpu_torch.tools.dist_train
    mode out`` (or ``python <worker...>``) with a time limit; the launcher
    tears its workers down on SIGTERM.  Returns ``(returncode, stderr,
    seconds)``."""
    cmd = [sys.executable, LAUNCH, "-n", str(n), "--coordinator",
           "127.0.0.1:%d" % _free_port(), *extra, "--", sys.executable,
           *(worker or ("-m", "mxnet_tpu_torch.tools.dist_train", mode,
                        out))]
    full_env = dict(os.environ, **(env or {}))
    full_env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, env=full_env, text=True,
                         stderr=subprocess.PIPE, start_new_session=True)
    try:
        _out, err = p.communicate(timeout=DIST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGTERM)
        try:
            p.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
        raise SystemExit("dist_train: the %s job outlived %d s"
                         % (mode, DIST_TIMEOUT_S))
    return p.returncode, err, time.perf_counter() - t0


def _ranks(out, name, n=2):
    return [json.load(open(os.path.join(out, "%s.rank%d.json" % (name, r))))
            for r in range(n)]


def _rel_losses(got, want):
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


@contextlib.contextmanager
def _async_records(out, r):
    """In a rank of the legs job: what a host replay of the ``dist_async``
    parameter server needs.  Each rank keeps what it sends (the
    optimizer's pickle, the initial values, each gradient by its CRC32) in
    ``OUT/async-sent.rank<r>.pkl``; the server (rank 0's) records
    ``(key, CRC32)`` as it applies each push (its updater runs under its
    lock), and that order goes to ``OUT/async-log.json`` and its final
    weights to ``OUT/async-server.npz``."""
    import copy
    import pickle
    import zlib
    from mxnet_tpu_torch.parallel import async_kvstore as ak
    sent = {"init": {}, "grads": {}}
    servers = []

    class RecordingServer(ak.ParameterServer):
        def __init__(self, *args, **kw):
            self.applied = []
            super().__init__(*args, **kw)
            servers.append(self)

        @property
        def _updater(self):
            return self.__dict__.get("_recorded_updater")

        @_updater.setter
        def _updater(self, fn):
            if fn is not None:
                inner = fn

                def fn(key, grad, weight):
                    self.applied.append((key, zlib.crc32(
                        np.ascontiguousarray(grad.asnumpy()).tobytes())))
                    return inner(key, grad, weight)
            self.__dict__["_recorded_updater"] = fn

    cls = ak.AsyncKVStore
    saved = (cls.init, cls._send_push, cls.set_optimizer, ak.ParameterServer)

    def init(self, key, value):
        for k, v in zip(*(key, value) if isinstance(key, (list, tuple))
                        else ([key], [value])):
            sent["init"][str(k)] = v.asnumpy().copy()
        return saved[0](self, key, value)

    def send(self, k, merged):
        sent["grads"][str(zlib.crc32(
            np.ascontiguousarray(merged).tobytes()))] = merged.copy()
        return saved[1](self, k, merged)

    def set_optimizer(self, optimizer):
        o = copy.copy(optimizer)
        o.sym = None
        sent["optimizer"] = pickle.dumps(o, protocol=4)
        return saved[2](self, optimizer)

    cls.init, cls._send_push, cls.set_optimizer = init, send, set_optimizer
    ak.ParameterServer = RecordingServer
    try:
        yield
    finally:
        cls.init, cls._send_push, cls.set_optimizer, ak.ParameterServer = \
            saved
    for srv in servers:
        with srv._lock:
            log = [[str(k), c] for k, c in srv.applied]
            final = {str(k): v.asnumpy() for k, v in srv._store.items()}
        np.savez(os.path.join(out, "async-server.npz"), **final)
        with open(os.path.join(out, "async-log.json"), "w") as f:
            json.dump(log, f)
    with open(os.path.join(out, "async-sent.rank%d.pkl" % r), "wb") as f:
        pickle.dump(sent, f, protocol=4)


def replay_async(out, ranks=2):
    """The server's final weights replayed on the host: the initial
    values, then the shipped optimizer's updater over each gradient in the
    order the server applied them.  Returns ``(pushes, keys, keys equal
    to the server's to the bit)``."""
    import pickle
    sent = []
    for r in range(ranks):
        with open(os.path.join(out, "async-sent.rank%d.pkl" % r), "rb") as f:
            sent.append(pickle.load(f))
    with open(os.path.join(out, "async-log.json")) as f:
        log = json.load(f)
    grads = {}
    for s in sent:
        grads.update(s["grads"])
    updater = mx.optimizer.get_updater(pickle.loads(sent[0]["optimizer"]))
    weights = {k: mx.nd.array(v, ctx=mx.cpu())
               for k, v in sent[0]["init"].items()}
    for key, crc in log:
        updater(int(key), mx.nd.array(grads[str(crc)], ctx=mx.cpu()),
                weights[key])
    final = np.load(os.path.join(out, "async-server.npz"))
    equal = sum(bool(np.array_equal(weights[k].asnumpy(), final[k]))
                for k in final.files)
    return len(log), len(final.files), equal


def _resnet_cfg(dtype):
    from mxnet_tpu_torch.tools import dist_train as dt
    return dict(dt.FULL["resnet"], dtype=dtype)


def dist_worker(out, resnet_dtype=None, cpu=False):
    """One rank of the dist_train phase's legs job (``chip_smoke.py
    --dist-worker OUT``, under the launcher): ``tools.dist_train``'s legs
    with the async server's records (:func:`_async_records`), then the
    control: ResNet-50 for two steps with each rank's BatchNorm over its
    own rows (the cross-rank sums switched off), which the phase's state
    gate must refuse.  With ``resnet_dtype``, ResNet-50 and its control
    alone, in that dtype; with ``cpu``, the tool's tiny CPU size."""
    from mxnet_tpu_torch.parallel import multihost
    from mxnet_tpu_torch.tools import dist_train as dt
    multihost.ensure_initialized()
    if cpu:
        ctx, cfg = mx.cpu(), dict(dt.TINY["resnet"])
    else:
        ctx = mx.gpu(multihost.device().index)
        cfg = _resnet_cfg(resnet_dtype or "bfloat16")
    if resnet_dtype:
        dt.resnet_leg(cfg, ctx, out)
    else:
        with _async_records(out, multihost.rank()):
            dt.main(["legs", out] + (["--cpu", "1"] if cpu else []))
    spans = multihost.batch_sums_span_ranks
    multihost.batch_sums_span_ranks = lambda: False
    try:
        dt.resnet_leg(cfg, ctx, out, "resnet_control", 2)
    finally:
        multihost.batch_sums_span_ranks = spans
    return 0


def _resnet_reference(cfg, steps, ctx=None, swap=False):
    """ResNet-50 in this process at the global batch, from the legs' seed
    and batch: its losses, and its masters and aux states before and
    after the first step (host arrays).  ``swap`` puts the batch's second
    half of rows first: the same sums in another order, so its distance
    from the unswapped run is the floor that rounding alone sets."""
    from mxnet_tpu_torch.tools import dist_train as dt
    tr = dt.resnet_trainer(cfg, ctx or mx.gpu(0))
    batch = dt.resnet_batch(cfg, 0)
    if swap:
        half = cfg["batch"] // 2
        batch = {k: np.concatenate([v[half:], v[:half]])
                 for k, v in batch.items()}
    before, losses = dt.host_state(tr), []
    for i in range(steps):
        losses.append(float(tr.step(batch)))
        if i == 0:
            after = dt.host_state(tr)
    del tr
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return losses, before, after


def _state_gaps(got, after, before, prefix, top=5):
    """||got - after|| / ||after - before|| over the arrays whose keys
    start with ``prefix`` (``arg:`` the masters, ``aux:`` the moving
    statistics), a two-rank step's distance from one process's in units
    of that step, as ``gap``; the median over the arrays of each one's own
    gap; and the ``top`` arrays by their share of the squared distance
    (name, share, own gap)."""
    keys = [k for k in after if k.startswith(prefix)]
    num = {k: float(np.square(got[k].astype(np.float64) - after[k]).sum())
           for k in keys}
    den = {k: float(np.square(after[k].astype(np.float64) - before[k])
                    .sum()) for k in keys}
    own = {k: (num[k] / den[k]) ** 0.5 if den[k] else float(num[k] > 0)
           for k in keys}
    total = sum(num.values())
    worst = sorted(keys, key=lambda k: -num[k])[:top]
    return {"gap": (total / sum(den.values())) ** 0.5,
            "median_own": float(np.median(list(own.values()))),
            "top": [[k, num[k] / total if total else 0.0, own[k]]
                    for k in worst]}


def _gaps(losses, state, ref):
    """``losses`` and the state after the first step against one process
    (``ref``): the largest relative loss difference and the state gaps."""
    ref_losses, before, after = ref
    if sorted(state) != sorted(after):
        raise SystemExit("dist_train: a state of other arrays than one "
                         "process's")
    parts = {k: _state_gaps(state, after, before, p)
             for k, p in (("params", "arg:"), ("aux", "aux:"))}
    return {"losses": losses,
            "max_rel_loss_diff": _rel_losses(losses, ref_losses),
            "state_gap": {k: v["gap"] for k, v in parts.items()},
            "state_gap_parts": parts}


def _resnet_readings(out, ref, floor):
    """The ResNet-50 leg and its control against one process (``ref``,
    :func:`_resnet_reference`), beside the floor (``floor``, the same run
    with the batch's halves swapped): the legs' records, and for each
    its largest relative loss difference and its state gaps after the
    first step."""
    got = {"floor": _gaps(floor[0], floor[2], ref)}
    for name in ("resnet", "resnet_control"):
        docs = _ranks(out, name)
        state = np.load(os.path.join(out, "%s.state1.npz" % name))
        got[name] = dict(_gaps(docs[0]["losses"],
                               {k: state[k] for k in state.files}, ref),
                         docs=docs)
    return got


def _gate_resnet(got):
    """The state gate on the moving statistics: the sound leg and the
    floor within ``TOL_DIST_AUX``, the control (each rank's BatchNorm
    over its own rows) beyond it.  The masters' gap is recorded beside
    the floor's, not gated: one step of ResNet-50 from its initial
    weights moves them by an amount that rounding alone changes by as
    much as a fault does."""
    for name in ("resnet", "floor"):
        aux = got[name]["state_gap"]["aux"]
        if not aux <= TOL_DIST_AUX:
            raise SystemExit("dist_train: ResNet-50's moving statistics "
                             "after a step (%s) lie %.3g of that step from "
                             "one process's; bound %g"
                             % (name, aux, TOL_DIST_AUX))
    aux = got["resnet_control"]["state_gap"]["aux"]
    if not aux > TOL_DIST_AUX:
        raise SystemExit("dist_train: the control (BatchNorm over each "
                         "rank's rows) reads %.3g on the moving statistics, "
                         "within the bound %g: the gate cannot tell it "
                         "from a sound run" % (aux, TOL_DIST_AUX))


def dist_witness(dtype):
    """ResNet-50 on two ranks against one process in ``dtype`` (``python
    chip_smoke.py --dist-witness float32``): the state gaps and loss
    differences of the sound leg and its control, printed as one JSON
    line with the card's name and power limit.  The dist_train phase runs
    the bf16 case; the f32 one tells rounding from a fault."""
    from mxnet_tpu_torch.tools import dist_train as dt
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    cfg = _resnet_cfg(dtype)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        ref = _resnet_reference(cfg, dt.RESNET_STEPS)
        floor = _resnet_reference(cfg, dt.RESNET_STEPS, swap=True)
        ref_s = time.perf_counter() - t0
        rc, err, job_s = _launch_job(
            "resnet", out, worker=(os.path.abspath(__file__),
                                   "--dist-worker", out, dtype))
        if rc != 0:
            raise SystemExit("dist_witness: the job failed (%d):\n%s"
                             % (rc, err[-6000:]))
        got = _resnet_readings(out, ref, floor)
    print(json.dumps({
        "dist_witness": dtype, "reference_losses": ref[0],
        "reference_s": ref_s, "job_s": job_s, "nvidia_smi": nvidia_smi(),
        **{k: {f: v[f] for f in ("losses", "max_rel_loss_diff",
                                 "state_gap", "state_gap_parts")}
           for k, v in got.items()},
        "build_s": [d["build_s"] for d in got["resnet"]["docs"]]}),
        flush=True)
    return 0


def dist_train_phase(workdir, gpt_ref):
    """Two ranks on the one card (gloo: NCCL refuses two ranks on one
    device) through the port's launcher, in three launches: the legs
    (``tools.dist_train``'s under :func:`dist_worker`: the full-width GPT,
    ResNet-50, the Module under dist_sync with overlap off and on, the
    Module under dist_async, then ResNet-50's control), the recovery
    drill (``--restart-budget 1``, rank 1 killed after step 2) and the
    NCCL route at world 1.  The references are this process's runs of
    the same weights and batch: ``gpt_ref`` the train phase's losses (the
    GPT at batch 16); ResNet-50 at batch 128 runs here first.  Gates: each
    launch's backend; the losses within ``TOL_DIST_LOSS`` of the
    references; ResNet-50's moving statistics after a step within
    ``TOL_DIST_AUX`` of one process's, and its control beyond it; the
    ranks' masters and aux states CRC32-equal; the Module's parameters
    equal with overlap off and on; the kernels' launches a step on each
    rank (K1, K3, delta 12 a GPT step; K5 16 a ResNet-50 step); the async
    server's weights equal to a host replay of its applied pushes; the
    resumed steps' losses equal to the uninterrupted run's to the bit; the
    NCCL push and pull equal to the bit.  Records each rank's peak memory,
    trainer build, step walls and collective wait with the card's name
    and power limit (two ranks time-share one card and gloo stages
    through host memory: a record, not a scaling number)."""
    from mxnet_tpu_torch.tools import dist_train as dt
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = _resnet_reference(_resnet_cfg("bfloat16"), dt.RESNET_STEPS)
    floor = _resnet_reference(_resnet_cfg("bfloat16"), dt.RESNET_STEPS,
                              swap=True)
    ref_s = time.perf_counter() - t0
    refs = {"gpt": list(gpt_ref[:dt.GPT_STEPS]), "resnet": ref[0]}
    out = os.path.join(workdir, "dist")
    os.makedirs(out, exist_ok=True)
    rc, err, legs_s = _launch_job(
        "legs", out, env={"MXNET_TPU_TELEMETRY_JSONL":
                          os.path.join(out, "run.jsonl"),
                          "MXNET_TPU_HEARTBEAT_TIMEOUT": "300"},
        worker=(os.path.abspath(__file__), "--dist-worker", out))
    if rc != 0:
        raise SystemExit("dist_train: the legs job failed (%d):\n%s"
                         % (rc, err[-6000:]))
    resnet = _resnet_readings(out, ref, floor)
    gpt, mod, asy = (_ranks(out, leg) for leg in ("gpt", "module", "async"))
    res, ctl = resnet["resnet"]["docs"], resnet["resnet_control"]["docs"]
    for leg, docs in (("gpt", gpt), ("resnet", res), ("module", mod),
                      ("async", asy), ("resnet_control", ctl)):
        heads = [(d["rank"], d["world"], d["backend"]) for d in docs]
        if heads != [(0, 2, "gloo"), (1, 2, "gloo")]:
            raise SystemExit("dist_train: %s ran as %s; want ranks 0 and 1 "
                             "of 2 on gloo" % (leg, heads))
    fields = {}
    for leg, docs, want in (("gpt", gpt, {
            "flash_attention_fwd_sm90": 12, "flash_attention_bwd_sm90": 12,
            "flash_attention_delta": 12}), ("resnet", res, {
                "matmul_stats": 16})):
        a, b = docs
        if a["params"] != b["params"] or a["aux"] != b["aux"]:
            raise SystemExit("dist_train: %s's ranks differ in their "
                             "masters or aux states (CRC32)" % leg)
        if a["losses"] != b["losses"]:
            raise SystemExit("dist_train: %s's ranks report other losses: "
                             "%s, %s" % (leg, a["losses"], b["losses"]))
        rel = _rel_losses(a["losses"], refs[leg])
        if not np.isfinite(a["losses"]).all() or rel > TOL_DIST_LOSS[leg]:
            raise SystemExit("dist_train: %s's losses %s against one "
                             "process's %s: %.3g over %g"
                             % (leg, a["losses"], refs[leg], rel,
                                TOL_DIST_LOSS[leg]))
        per_step = []
        for d in docs:
            counts = dict(d["launches"], **d["source_launches"])
            got = {k: counts[k] / d["steps"] for k in want}
            if got != {k: float(v) for k, v in want.items()}:
                raise SystemExit("dist_train: %s rank %d launched %s a "
                                 "step; want %s" % (leg, d["rank"], got,
                                                    want))
            per_step.append(got)
        fields[leg] = {
            "losses": a["losses"], "reference_losses": refs[leg],
            "max_rel_loss_diff": rel, "launches_per_step": per_step[0],
            "params_crc_equal": True,
            "step_wall_s": [d["step_wall_s"] for d in docs],
            "collective_wait_s": [d["collective_wait_s"] for d in docs],
            "peak_mem_bytes": [d.get("peak_mem_bytes") for d in docs],
            "build_s": [d["build_s"] for d in docs]}
    fields["gpt"]["context_s"] = [d["context_s"] for d in gpt]
    if res[0]["fusion"]["pallas_blocks"] != 16:
        raise SystemExit("dist_train: ResNet-50's plan %s; want 16 blocks "
                         "on K5" % res[0]["fusion"])
    print("dist_train ResNet-50 against one process: %s" % json.dumps(
        {k: {f: v[f] for f in ("losses", "max_rel_loss_diff",
                               "state_gap_parts")}
         for k, v in resnet.items()}), flush=True)
    _gate_resnet(resnet)
    fields["resnet"].update(
        state_gap=resnet["resnet"]["state_gap"],
        state_gap_parts=resnet["resnet"]["state_gap_parts"],
        reference_s=ref_s)
    for name in ("resnet_control", "floor"):
        fields["resnet_" + name.replace("resnet_", "")] = {
            k: resnet[name][k] for k in ("losses", "max_rel_loss_diff",
                                         "state_gap", "state_gap_parts")}
    m0, m1 = mod
    for o in ("overlap0", "overlap1"):
        if m0[o]["params"] != m1[o]["params"]:
            raise SystemExit("dist_train: the Module's ranks differ (%s)" % o)
    if m0["overlap0"]["params"] != m0["overlap1"]["params"]:
        raise SystemExit("dist_train: the Module's parameters differ with "
                         "overlap on and off")
    if [m0[o]["overlap_active"] for o in ("overlap0", "overlap1")] != \
            [False, True]:
        raise SystemExit("dist_train: the overlap path did not switch")
    fields["module"] = {
        o: {k: m0[o][k] for k in ("batch_wall_s", "collectives",
                                  "source_launches")}
        for o in ("overlap0", "overlap1")}
    fields["module"].update(params_equal_overlap_on_off=True,
                            batches=dt.MODULE_BATCHES,
                            layers=dt.MODULE_LAYERS)
    pushes, keys, equal = replay_async(out)
    if equal != keys or pushes != asy[0]["stats"]["updates"]:
        raise SystemExit("dist_train: the async server's weights: %d of %d "
                         "keys equal a host replay of its %d applied pushes "
                         "(%d updates)" % (equal, keys, pushes,
                                           asy[0]["stats"]["updates"]))
    fields["async"] = {"pushes": pushes, "keys": keys, "replay_equal": True,
                       "batch_wall_s": [d["batch_wall_s"] for d in asy]}
    timeline = [json.loads(line) for line in
                open(os.path.join(out, "run.jsonl.run"))]
    fields["legs_launch"] = {
        "seconds": legs_s, "backend": "gloo",
        "timeline_steps": sum(r.get("kind") == "step" for r in timeline)}
    # launch 2: the recovery drill
    rc, err, rec_s = _launch_job(
        "recovery", out, extra=("--restart-budget", "1"),
        env={"MXNET_TPU_HEARTBEAT_TIMEOUT": "60"})
    if rc != 0 or "job recovered after 1 restart(s)" not in err:
        raise SystemExit("dist_train: the recovery drill (%d):\n%s"
                         % (rc, err[-6000:]))
    full, resumed = (_ranks(out, n) for n in ("uninterrupted", "resumed"))
    for u, r_ in zip(full, resumed):
        if r_["epoch"] != dt.KILL_AFTER or \
                r_["losses"] != u["losses"][dt.KILL_AFTER:]:
            raise SystemExit("dist_train: resumed from epoch %s with losses "
                             "%s; the uninterrupted run's %s"
                             % (r_["epoch"], r_["losses"], u["losses"]))
    fields["recovery"] = {
        "seconds": rec_s, "uninterrupted": full[0]["losses"],
        "resumed": resumed[0]["losses"], "epoch": resumed[0]["epoch"],
        "bit_equal": True, "load_s": [d["load_s"] for d in resumed],
        "save_s": _ranks(out, "checkpointed")[0]["save_s"]}
    # launch 3: the NCCL route, one process
    rc, err, nccl_s = _launch_job("nccl", out, n=1)
    if rc != 0:
        raise SystemExit("dist_train: the NCCL job failed (%d):\n%s"
                         % (rc, err[-6000:]))
    nccl = _ranks(out, "nccl", n=1)[0]
    if nccl["backend"] != "nccl" or not nccl["equal"] \
            or nccl["collectives"] != 1:
        raise SystemExit("dist_train: the NCCL route: %s" % nccl)
    fields["nccl"] = dict(nccl, seconds=nccl_s)
    print("dist_train backends: legs gloo, recovery gloo, nccl %s"
          % nccl["backend"], flush=True)
    return dict(fields, nvidia_smi=nvidia_smi(),
                tolerance=TOL_DIST_LOSS,
                phase_s=time.perf_counter() - t_phase)


#: the launch counter (:func:`kernel_counts`) of each summary entry's kernel
COUNTER_OF = {
    "flash_attention_fwd": "flash_attention_fwd",
    "flash_attention_fwd_sm90": "flash_attention_fwd",
    "flash_attention_bwd": "flash_attention_bwd",
    "flash_attention_bwd_sm90": "flash_attention_bwd",
    "flash_attention_delta": "flash_attention_delta",
    "matmul_stats": "matmul_stats", "matmul_stats_f32": "matmul_stats_f32",
    "rtc": "rtc",
    "matmul_stats_experiment.matmul_stats": "matmul_stats",
    "matmul_stats_experiment.matmul_stats_prologue":
        "matmul_stats_prologue",
    "bottleneck_block": "bottleneck_block",
    "bottleneck_block_general": "bottleneck_block_general"}


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
    emit("op_corpus", **op_corpus_phase())
    autograd = autograd_check_phase(mx.gpu(0))
    emit("autograd_check", **autograd)
    dcgan_run = dcgan_train_phase(mx.gpu(0))
    emit("dcgan_train", **dcgan_run)
    emit("dcgan_check", **dcgan_check_phase(mx.gpu(0)))
    detection = detection_ops_phase()
    emit("detection_ops", **detection)
    with tempfile.TemporaryDirectory() as workdir:
        ssd_run = ssd_train_phase(mx.gpu(0), workdir)
        ssd_run["detection_share_of_batch"] = \
            detection["ms"]["multibox_detection"] / ssd_run["median_batch_ms"]
        ssd_run["nms_loop_share_of_batch"] = \
            detection["ms"]["nms_loop"] / ssd_run["median_batch_ms"]
        emit("ssd_train", **ssd_run)
        emit("ssd_check", **ssd_check_phase(mx.gpu(0), workdir))
    rcnn_run = rcnn_train_phase(mx.gpu(0))
    emit("rcnn_train", **rcnn_run)
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
        resume = resume_train_phase(mx.gpu(0), recs, workdir)
        emit("resume_train", **resume)
        tele = telemetry_train_phase(mx.gpu(0), recs, workdir)
        emit("telemetry_train", **tele)
    analysis = analysis_phase(mx.gpu(0), FULL, serve_memory=serve["memory"])
    emit("analysis", **analysis)
    zoo_k5 = zoo_kernels_phase()
    emit("zoo_kernels", **zoo_k5)
    with tempfile.TemporaryDirectory() as workdir:
        recs, records_s = make_image_records(
            workdir, INCEPTION_RECORDS, size=INCEPTION_RECORD_SIZE)
        inception = inception_train_phase(mx.gpu(0), recs)
        emit("inception_train", records_s=records_s, **inception)
    emit("inception_check", **inception_check_phase(mx.gpu(0)))
    zoo_score = zoo_score_phase(mx.gpu(0), batch1=ZOO_SCORE_BATCH1)
    emit("zoo_score", **zoo_score)
    zoo_serve = zoo_serve_phase(mx.gpu(0))
    emit("zoo_serve", **zoo_serve)
    ring = ring_gpt_phase(mx.gpu(0))
    emit("ring_gpt", **ring)
    contrib = contrib_ops_phase()
    emit("contrib_ops", **contrib)
    ctc = ctc_ocr_phase(mx.gpu(0))
    emit("ctc_ocr", **ctc)
    rtc = rtc_phase()
    mse = matmul_stats_experiment_phase()
    blk = block_experiment_phase()
    # it commits tuned tiles and a plan, then empties the cache
    with tempfile.TemporaryDirectory() as workdir:
        tuned = autotune_phase(mx.gpu(0), workdir)
    emit("autotune", **tuned)
    with tempfile.TemporaryDirectory() as workdir:
        dist = dist_train_phase(workdir, train["losses"])
    emit("dist_train", **dist)
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
    kernels = [
        # f32, the split-TF32 kernels: serving (K1) and the f32 train check
        kernel_summary(
            "flash_attention_fwd", fwd_src["float32"], k1, k2,
            _case(fwd, [4, 1024, 16, 64], "float32"), serve["launches"],
            launches_from="serve: the device trace of the requests' %d "
            "graph replays" % serve["window_dispatches"],
            capture_launches=serve["capture_launches"],
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
                   imagenet_steps=imagenet["steps"],
                   inception=k5_inception_fields(zoo_k5, inception)),
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
    ]
    # each kernel's launches on the DCGAN path, in autograd_check's
    # recorded f32 attention and on the detection path (ssd_train and
    # rcnn_train summed): the flash forward and backward by source (f32
    # and bf16 apart), the rest by their wrapper's counter
    detection_counts = {k: ssd_run["kernel_launches"][k]
                        + rcnn_run["kernel_launches"][k]
                        for k in ssd_run["kernel_launches"]}
    detection_by_source = {k: ssd_run["flash_source_launches"][k]
                           + rcnn_run["flash_source_launches"][k]
                           for k in ssd_run["flash_source_launches"]}
    # the zoo's other paths: scoring, serving, the contrib ops and the OCR
    zoo_counts = {k: sum(r["kernel_launches"][k] for r in (
        zoo_score, zoo_serve, contrib, ctc)) for k in kernel_counts()}
    for e in kernels:
        counter = COUNTER_OF[e["name"]]
        for key, run, by_source in (
                ("dcgan_launches", dcgan_run["kernel_launches"],
                 dcgan_run["flash_source_launches"]),
                ("autograd_launches", autograd["flash"]["launches"],
                 autograd["flash"]["source_launches"]),
                ("detection_launches", detection_counts,
                 detection_by_source),
                ("inception_launches", inception["kernel_launches"],
                 inception["flash_source_launches"]),
                ("ring_gpt_launches", ring["kernel_launches"],
                 ring["flash_source_launches"]),
                ("resume_launches", resume["kernel_launches"], {}),
                ("telemetry_launches", tele["kernel_launches_per_step"],
                 {}),
                ("analysis_launches", analysis["kernel_launches"],
                 analysis["flash_source_launches"]),
                ("zoo_launches", zoo_counts, {})):
            if e["name"] in by_source:
                e[key] = by_source[e["name"]]
            elif e["name"] == "matmul_stats":       # K5's bf16 launches
                e[key] = run[counter] - run["matmul_stats_f32"]
            else:
                e[key] = run[counter]
    # each kernel's tiles: the built-in one, the legal set, the tuners'
    # winner and both device times (autotune); K6, K9 and delta take none
    k5_tiles = {dt: [t for t in tuned["k5_tiles"] if t["dtype"] == dt]
                for dt in ("bfloat16", "float32")}
    tiles = {
        "flash_attention_fwd": tuned["flash_tiles"]["fwd_float32_4"],
        "flash_attention_bwd": tuned["flash_tiles"]["bwd_float32_4"],
        "flash_attention_fwd_sm90": tuned["flash_tiles"]["fwd_bfloat16_16"],
        "flash_attention_bwd_sm90": tuned["flash_tiles"]["bwd_bfloat16_16"],
        "matmul_stats": k5_tiles["bfloat16"],
        "matmul_stats_f32": k5_tiles["float32"],
        "matmul_stats_experiment.matmul_stats": {
            "tuned": False, "heuristic": "bf16_tile (K5's rule)",
            "legal": [64, 128, 256]},
        "matmul_stats_experiment.matmul_stats_prologue": {
            "tuned": False, "heuristic": "the widest tile N needs",
            "legal": [64, 128, 256]}}
    for e in kernels:
        e["tiles"] = tiles.get(e["name"], {"tuned": False,
                                            "takes_tile": False})
    # each kernel's launches on each rank of the two-rank dist_train legs:
    # a step of the bf16 GPT (K1, K3, delta) and of ResNet-50 (K5), a
    # batch of the f32 Module (the f32 flash kernels)
    gpt_steps = dist["gpt"]["launches_per_step"]
    module_batch = {k: v / dist["module"]["batches"] for k, v in
                    dist["module"]["overlap0"]["source_launches"].items()
                    if not k.endswith("_sm90")}
    dist_launches = dict(gpt_steps, **module_batch,
                         matmul_stats=dist["resnet"]["launches_per_step"][
                             "matmul_stats"])
    for e in kernels:
        e["dist_train_launches"] = dist_launches.get(e["name"], 0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--dist-witness"]:
        sys.exit(dist_witness(sys.argv[2]))
    sys.exit(main())
