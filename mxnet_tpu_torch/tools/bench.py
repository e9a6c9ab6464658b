"""ResNet training throughput (images/s/chip) on one NVIDIA GPU.

    python -m mxnet_tpu_torch.tools.bench             # one JSON line
    python -m mxnet_tpu_torch.tools.bench --dry-run   # the tiny MLP leg

The port's counterpart of the training leg of the repo's ``bench.py``, with
its environment variables and defaults: ``BENCH_BATCH`` (128),
``BENCH_IMAGE`` (224), ``BENCH_LAYERS`` (50), ``BENCH_STEPS`` (50),
``BENCH_DTYPE`` (bfloat16), ``BENCH_SCAN`` (10), ``BENCH_OPTIMIZER``
(sgd), ``BENCH_LAYOUT`` (NHWC) and ``BENCH_FUSE_BLOCKS`` (1).  It builds
``models.get_model("resnet<layers>")`` under ``ShardedTrainer`` on
``gpu(0)`` (SGD lr 0.1, momentum 0.9, weight decay 1e-4), stages one batch
from ``RandomState(0)``, warms up with two ``step`` calls and one
``run_steps`` chain, clears the telemetry step window
(``telemetry.reset_steps``), and times chains of ``BENCH_SCAN`` steps on
the host clock between ``torch.cuda.synchronize()`` calls.

It prints ``bench.py``'s fields (``metric``, ``value``, ``unit``,
``vs_baseline`` against the reference's 45.52 img/s on one K80, ``valid``,
the fusion plan's summary, the ``telemetry`` block of
``telemetry.report()`` — step-time percentiles, throughput, compiles,
per-phase spans, memory — and the ``io`` block of
``telemetry.ioview.summary()``, empty stages on this synthetic batch) plus
the card's name and ``nvidia-smi``'s name and power limit, since a card
set below its 700 W maximum runs slower under load.

``--dry-run`` (or ``BENCH_DRYRUN=1``) is the JAX dry-run leg: the tiny
MLP (``models.get_model("mlp", num_classes=10)``, batch 8 of 64
features, SGD lr 0.1, f32), one step to warm up, then 5 timed steps; with
``BENCH_FUSE_BLOCKS`` on, the unfused A/B leg runs first, so the primary
leg owns the telemetry step window.  ``step_program_eqns`` counts the
graph nodes the eager step dispatches (a fused block counts once), the
counterpart of the JAX step program's top-level equations.  It adds the
``numerics`` block.  Both legs carry the JAX line's ``costdb`` block:
``telemetry.costdb.summary()`` (each program's measured wall, flops and
MFU, the worst-MFU blocks and kernels; ``MXNET_TPU_COSTDB_SAMPLE`` sets the
sampling) and ``flushed_to``, the JSONL file ``MXNET_TPU_COSTDB`` names.
Both carry the ``autotune`` block, ``autotune.summary()``: the tuning
cache's mode, directory and size, its hit, miss and search counts and the
tuned configs this run dispatched with.  With ``BENCH_FUSE_BLOCKS`` on,
the dry-run leg adds the plan-search A/B (``fusion.plansearch``): a
whole-graph plan search of the MLP under a small budget, greedy and the
searched winner measured on the same inputs, committed to the tuning
cache (a committed entry reads as a hit, no search).  The overlap leg is
not ported (ROADMAP Queue A item 4).

The JAX options ``stem_space_to_depth`` and ``auto_layouts`` are TPU-era
rewrites the port does not have: it passes both as False.  The ``--serve``
leg is not ported.  Both legs need a CUDA device and fail without one;
``--cpu`` runs them on the CPU instead (the tests do).
"""
from __future__ import annotations

import json
import os
import sys
import time

from . import nvidia_smi

#: the reference's published ResNet-50 training rate on one K80 (img/s)
BASELINE_IMG_S = 45.52


def build_trainer(batch, image, num_layers=50, dtype="bfloat16",
                  layout="NHWC", fuse_blocks=True, optimizer="sgd",
                  learning_rate=0.1, ctx=None):
    """``(trainer, staged batch)``: ``bench.py``'s ResNet trainer on a
    one-device mesh on ``ctx`` (default ``gpu(0)``) and one batch of
    uniform(-1, 1) images and random labels from ``RandomState(0)``,
    staged once."""
    import numpy as np

    from ..context import gpu
    from ..models import get_model
    from ..parallel import ShardedTrainer, build_mesh

    net = get_model("resnet%d" % num_layers, num_classes=1000,
                    image_shape="3,%d,%d" % (image, image))
    trainer = ShardedTrainer(
        net, build_mesh(devices=[ctx or gpu(0)]),
        data_shapes={"data": (batch, 3, image, image)},
        label_shapes={"softmax_label": (batch,)}, optimizer=optimizer,
        learning_rate=learning_rate, momentum=0.9, weight_decay=1e-4,
        dtype=dtype,
        layout=layout, auto_layouts=False, stem_space_to_depth=False,
        fuse_blocks=fuse_blocks)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (batch, 3, image, image)).astype(np.float32)
    y = rng.randint(0, 1000, batch).astype(np.float32)
    return trainer, trainer.put_batch({"data": x, "softmax_label": y})


def time_chains(trainer, staged, steps, scan):
    """Run ``steps // scan`` chains of ``run_steps(staged, scan)`` (at
    least one) between two ``torch.cuda.synchronize()`` calls when the
    trainer lives on the card; returns ``(steps run, seconds, last
    losses)``."""
    import torch

    def sync():
        if trainer.mesh.device.type == "cuda":
            torch.cuda.synchronize()

    chains = max(1, steps // scan)
    sync()
    t0 = time.perf_counter()
    for _ in range(chains):
        losses = trainer.run_steps(staged, scan)
    sync()
    return chains * scan, time.perf_counter() - t0, losses


def step_program_eqns(trainer):
    """The graph nodes the trainer's eager step dispatches: every op node,
    a fused block counting once (its interior is skipped).  The
    counterpart of the JAX step program's top-level equation count."""
    from ..analysis import fusion as _fusion
    from ..ops.fused import block_fusion
    from ..ops.nn import image_layout
    topo = trainer.symbol._topo()
    ops = [n for n in topo if not n.is_variable]
    if not trainer._fuse_blocks:
        return len(ops)
    with image_layout(trainer._layout), block_fusion(True):
        plan = _fusion.plan_block_fusion(
            topo, trainer.symbol._entries, layout=trainer._layout,
            is_train=True)
    return len(ops) - len(plan.skip)


def emit(result, fusion=None, numerics=False):
    """Add ``valid``, the fusion block, the ``costdb``, ``io`` and
    ``telemetry`` blocks (and the ``numerics`` roll-up) and print the
    one-line JSON."""
    from .. import autotune, telemetry
    from ..telemetry import costdb
    rep = telemetry.report()
    result["valid"] = True
    if fusion is not None:
        result["fusion"] = fusion
    cost = costdb.summary()
    cost["flushed_to"] = costdb.flush()
    result["costdb"] = cost
    result["io"] = telemetry.ioview.summary()
    # the tuning cache's attribution: hits, misses and the tuned configs
    # this run dispatched with
    result["autotune"] = autotune.summary()
    if numerics:
        result["numerics"] = telemetry.numerics.summary()
    result["telemetry"] = {k: rep[k] for k in (
        "steps", "step_time_s", "throughput", "compile", "phases",
        "memory")}
    print(json.dumps(result), flush=True)
    return result


def dry_run(ctx, fuse_blocks=True, steps=5):
    """The JAX dry-run leg on ``ctx``; prints and returns its line."""
    import numpy as np

    from .. import telemetry
    from ..models import get_model
    from ..parallel import ShardedTrainer, build_mesh

    batch = 8
    rng = np.random.RandomState(0)
    host_batch = {
        "data": rng.uniform(-1, 1, (batch, 64)).astype(np.float32),
        "softmax_label": rng.randint(0, 10, batch).astype(np.float32)}

    def make(fuse):
        return ShardedTrainer(
            get_model("mlp", num_classes=10), build_mesh(devices=[ctx]),
            data_shapes={"data": (batch, 64)},
            label_shapes={"softmax_label": (batch,)},
            optimizer="sgd", learning_rate=0.1, dtype="float32",
            fuse_blocks=fuse)

    fusion = {"enabled": fuse_blocks}
    if fuse_blocks:
        # the unfused A/B leg first: the primary leg below owns the
        # telemetry step window and the plan summary
        t_b = make(False)
        b_dict = t_b.put_batch(host_batch)
        float(t_b.step(b_dict))
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = t_b.step(b_dict)
        if not np.isfinite(float(loss)):
            raise SystemExit("bench: non-finite dry-run loss")
        dt_b = time.perf_counter() - t0
        fusion["ab_unfused"] = {
            "samples_per_sec_per_chip": round(steps * batch / dt_b, 2),
            "step_program_eqns": step_program_eqns(t_b)}
    trainer = make(fuse_blocks)
    batch_dict = trainer.put_batch(host_batch)
    float(trainer.step(batch_dict))
    telemetry.reset_steps()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = trainer.step(batch_dict)
    if not np.isfinite(float(loss)):
        raise SystemExit("bench: non-finite dry-run loss")
    dt = time.perf_counter() - t0
    fusion["summary"] = trainer.fusion_summary()
    fusion["step_program_eqns"] = step_program_eqns(trainer)
    if fuse_blocks:
        fusion["plansearch"] = plansearch_ab(ctx, batch)
    return emit({"metric": "dryrun_mlp_train_samples_per_sec_per_chip",
                 "value": round(steps * batch / dt, 2),
                 "unit": "samples/s/chip", "vs_baseline": 0},
                fusion=fusion, numerics=True)


def plansearch_ab(ctx, batch):
    """The dry-run leg's plan-search A/B: a plan search of the MLP under a
    small budget (12 plans scored, a beam of 4, the 2 best measured beside
    greedy on the same inputs), committed to the tuning cache; a
    committed entry reads as a hit with no search."""
    from ..analysis import plansearch
    from ..models import get_model
    doc = plansearch.search_and_commit(
        get_model("mlp", num_classes=10),
        {"data": (batch, 64), "softmax_label": (batch,)},
        layout="NCHW", budget=12, beam=4, topk=2, repeats=2,
        device=ctx.torch_device())
    return {k: doc.get(k) for k in (
        "graph", "plan_id", "cached", "searched", "measured",
        "predicted_s", "greedy_predicted_s", "wall_s", "greedy_wall_s",
        "candidates")}


def main(argv=None):
    import numpy as np
    import torch

    from .. import telemetry
    from ..context import cpu, gpu

    argv = sys.argv[1:] if argv is None else list(argv)
    env = os.environ.get
    on_cpu = "--cpu" in argv
    if not on_cpu and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; this tool measures the GPU "
                         "(--cpu runs it on the CPU)")
    ctx = cpu() if on_cpu else gpu(0)
    fuse_blocks = env("BENCH_FUSE_BLOCKS", "1") == "1"
    if "--dry-run" in argv or env("BENCH_DRYRUN", "0") == "1":
        return dry_run(ctx, fuse_blocks)
    batch = int(env("BENCH_BATCH", "128"))
    image = int(env("BENCH_IMAGE", "224"))
    num_layers = int(env("BENCH_LAYERS", "50"))
    steps = int(env("BENCH_STEPS", "50"))
    scan = max(1, int(env("BENCH_SCAN", "10")))
    trainer, staged = build_trainer(
        batch, image, num_layers, dtype=env("BENCH_DTYPE", "bfloat16"),
        layout=env("BENCH_LAYOUT", "NHWC"), fuse_blocks=fuse_blocks,
        optimizer=env("BENCH_OPTIMIZER", "sgd"), ctx=ctx)
    float(trainer.step(staged))
    float(trainer.step(staged))
    float(trainer.run_steps(staged, scan)[-1])
    # the warm-up's steps leave the step window; compiles stay counted
    telemetry.reset_steps()
    done, seconds, losses = time_chains(trainer, staged, steps, scan)
    if not np.isfinite(float(losses[-1])):
        raise SystemExit("bench: non-finite loss %r" % losses)
    img_per_sec = done * batch / seconds
    result = {
        "metric": "resnet%d_train_images_per_sec_per_chip" % num_layers,
        "value": round(img_per_sec, 2), "unit": "img/s/chip",
        "vs_baseline": round(img_per_sec / BASELINE_IMG_S, 3),
        "step_ms": seconds / done * 1e3, "steps": done, "batch": batch,
        "image": image}
    if not on_cpu:
        result.update(device=torch.cuda.get_device_name(0),
                      nvidia_smi=nvidia_smi())
    return emit(result, fusion={"enabled": fuse_blocks,
                                "summary": trainer.fusion_summary()})


if __name__ == "__main__":
    main()
